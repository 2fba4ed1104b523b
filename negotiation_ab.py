#!/usr/bin/env python3
"""The np=2 ResNet-50 job of ``chip_smoke.py`` (phase 10) with the response
cache on and off, in alternating order, on one GPU.

    python3 negotiation_ab.py [--pairs 3]

Each pair runs the job twice, once with the default cache (1024 entries)
and once with ``--cache-capacity 0``; the order flips from pair to pair
(on/off, off/on, ...), so that a drift of the shared host over the call
does not favour one side.  Every run prints, per rank and step, the step
ms, the host plane's op ms and the wall ms in ``compute_response_list``;
the last line is a JSON summary of the medians over steps 2 and 3 (step 1
negotiates every tensor in full either way) per setting, and the number
of pairs in which the cache-on run's median step was the faster.  The
runs must give the same parameter hash after every step, as in
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

import chip_smoke


def main() -> int:
    if not torch.cuda.is_available():
        print("negotiation_ab: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--pairs", type=int, default=3)
    args = parser.parse_args()
    card_line = chip_smoke.card()
    print(card_line, flush=True)
    runs = {"on": [], "off": []}
    hashes = set()
    on_faster = 0
    for pair in range(args.pairs):
        order = ("on", "off") if pair % 2 == 0 else ("off", "on")
        medians = {}
        for setting in order:
            launcher_args = [] if setting == "on" else ["--cache-capacity",
                                                        "0"]
            seconds, ranks = chip_smoke.run_np2_resnet(launcher_args)
            hashes.add(tuple(s["hash"] for s in ranks[0]["steps"]))
            later = {k: [s[k] for r in ranks for s in r["steps"][1:]]
                     for k in ("ms", "plane_ms", "negotiation_ms")}
            runs[setting].append(later)
            medians[setting] = statistics.median(later["ms"])
            for r, rank in enumerate(ranks):
                steps = rank["steps"]
                print(f"pair {pair} cache {setting}: rank {r} ms/step "
                      f"{[round(s['ms'], 1) for s in steps]}, plane op "
                      f"{[round(s['plane_ms'], 1) for s in steps]}, "
                      f"compute_response_list "
                      f"{[round(s['negotiation_ms'], 1) for s in steps]}, "
                      f"serialized requests "
                      f"{[s['serialized_request_count'] for s in steps]} "
                      f"({seconds:.1f}s with the launch) [{card_line}]",
                      flush=True)
        on_faster += medians["on"] < medians["off"]
    if len(hashes) != 1:
        raise AssertionError(f"the runs' parameter hashes differ: {hashes}")
    summary = {"pairs": args.pairs, "on_faster_pairs": on_faster}
    for setting, per_run in runs.items():
        for key in ("ms", "plane_ms", "negotiation_ms"):
            summary[f"{setting}_{key}_median"] = statistics.median(
                v for run in per_run for v in run[key])
            summary[f"{setting}_{key}_per_run"] = [
                statistics.median(run[key]) for run in per_run]
    print(card_line, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
