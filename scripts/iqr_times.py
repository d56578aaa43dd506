#!/usr/bin/env python3
"""The ``iqr`` kernel's entry-point calls, timed on one NVIDIA card, for
the checkout whose ``src/`` is given.

    python3 scripts/iqr_times.py [--src SRC] [--label NAME]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``), so
that an earlier commit unpacked beside this one (``git archive`` into a
directory that ``.gitignore`` lists) can be timed in the same call, on the
same card: its kernels are built from its own sources into its own
``build/torch_kernels/``. Run the two in turns (earlier, this, this,
earlier) to see the spread. Each row goes through
``repro_torch.kernels.iqr_fences``, is first held against the plain
version (sorted table, flags and stats equal), and is then timed with
``chip_smoke.py``'s ``iqr_row``: CUDA events around 20 calls, the own and
other device time of a call under torch.profiler with the own kernels a
call, the plain version, ``torch.quantile`` of the occupied scores, and
the bound, each read twice where chip_smoke.py reads it twice. Rows:

  f64/12000   12,000 seeded float64 scores, 80% occupied (the analysis
              path's table size)
  f32/12000   the same scores in float32
  f32/micro   the reference micro-bench's 4,096 float32 scores and seed
  f64/120000  120,000 seeded float64 scores, 80% occupied (1 ms bins of
              the Table-1 trace: the large-table path)

Prints the card's name and power limit as nvidia-smi gives them, then one
JSON line per row, and writes the lines to
``build/iqr_times_<label>.jsonl``. Needs one CUDA card and nvcc; exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("iqr_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.iqr import ops as iq

    card = cs.phase_card()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    s12, o12 = cs.iqr_table(dev, 12_000, 12)
    m_scores, m_occ = cs.micro_inputs(dev)[3:5]
    rows = {"f64/12000": (s12, o12),
            "f32/12000": (s12.to(torch.float32), o12),
            "f32/micro": (m_scores, m_occ),
            "f64/120000": cs.iqr_table(dev, cs.IQR_120K, 120)}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    lines = []
    for name, (scores, occ) in rows.items():
        cs.iqr_err(iq.iqr_fences(scores, occ),
                   iq.iqr_fences_plain(scores, occ))
        row = cs.iqr_row(iq.iqr_fences, iq.iqr_fences_plain, scores, occ)
        line = json.dumps({"label": args.label, "row": name, "card": card,
                           "src": args.src, **row})
        print(line, flush=True)
        lines.append(line)
    (out_dir / f"iqr_times_{args.label}.jsonl").write_text(
        "\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
