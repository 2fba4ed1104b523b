"""Cross-rank transport: the rendezvous store (``store.py``) and the byte
exchange of the negotiation rounds over the gloo control group
(``control.py``)."""
