"""Run some of chip_smoke.py's training phases alone on the card.

    python3 tools/chip_smoke_phases.py [tp_step] [remat] [tp_serve]
        [tp_recurrent] [tp_recurrent_serve] [tp_frontends]
        [tp_long_decode] [tp_frontends_serve] [tp_heads] [tp_tied]

Builds the kernels, then runs the named phases (default: all ten) with
chip_smoke.py's own functions and prints their JSON lines: ``tp_step``,
``tp_recurrent``, ``tp_frontends``, ``tp_long_decode``, ``tp_heads`` and
``tp_tied`` run ``sharded_step`` first (its ranks run both routes, the
recurrent families' and the frontends' split, the batch-1 decodes, the
heads that do not divide over "model" and the tied head on (1, 4), one
spawn for all; tp_heads also times the row
``flash_attention_head_offset``, whose launches tp_tied adds to),
``tp_serve``, ``tp_recurrent_serve`` and ``tp_frontends_serve`` run
tp_serve's ranks (one spawn for the three); the ``kernels`` line of the
rows they timed comes last. A failed check is printed and the next phase
still runs; the exit code is 1 if any check or phase failed, 2 where
there is no card.
"""
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("tp_step", "remat", "tp_serve", "tp_recurrent",
          "tp_recurrent_serve", "tp_frontends", "tp_long_decode",
          "tp_frontends_serve", "tp_heads", "tp_tied")
SHARDED = ("tp_step", "tp_recurrent", "tp_frontends", "tp_long_decode",
           "tp_heads", "tp_tied")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    failed = []

    def soft_fail(msg):
        failed.append(msg)
        print("CHECK FAILED:", msg, flush=True)

    cs.fail = soft_fail
    which = sys.argv[1:] or list(PHASES)
    unknown = set(which) - set(PHASES)
    if unknown:
        sys.exit(f"chip_smoke_phases: unknown phases {sorted(unknown)}")
    dev = torch.device("cuda")
    card = cs.nvidia_smi()
    t0 = time.perf_counter()
    _build.build_all()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    rows = {}
    record = cs.make_record(rows)
    sharded, served = None, False
    for name in which:
        t0 = time.perf_counter()
        try:
            if name in SHARDED:
                if sharded is None:
                    sharded = cs.sharded_step_phase(dev, card)
                if name == "tp_step":
                    cs.tp_step_phase(dev, card, sharded)
                elif name == "tp_recurrent":
                    cs.tp_recurrent_phase(dev, card, sharded)
                elif name == "tp_frontends":
                    cs.tp_recurrent_phase(dev, card, sharded, name,
                                          cs.TP_FRONT_TRAIN,
                                          "_frontends_ranks")
                elif name in ("tp_heads", "tp_tied"):
                    cs.tp_heads_phase(dev, rows, record, card, sharded, name)
                else:
                    cs.tp_long_decode_phase(dev, card, sharded)
            elif name == "remat":
                cs.remat_phase(dev, card)
            elif not served:        # tp_serve runs the other two serve phases
                served = True
                cs.tp_serve_phase(dev, rows, record, card)
        except Exception as e:      # the next phase still runs
            traceback.print_exc()
            failed.append(f"{name}: {e!r}")
        cs.emit({"phase": f"driver:{name}",
                 "seconds": time.perf_counter() - t0})
    if rows:
        cs.emit({"kernels": list(rows.values())})
    print(card)
    print({"failed": failed})
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
