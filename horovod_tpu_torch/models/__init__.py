"""Models of the port (counterparts of ``horovod_tpu/models``)."""
