"""The steps that ``ssd_stage_times.py`` and ``iqr_stage_times.py`` share:
copies of one CUDA source, each with one stage taken out by exact text
edits (checked to apply), built together with nvcc, then each timed in a
process of its own, the copies in one order and then in the reverse
order. A script gives its source, its build directory, its variants and a
function that times one built library; :func:`main` does the rest.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Tuple

ROOT = Path(__file__).resolve().parent.parent
Edits = List[Tuple[str, str]]


def variant_source(source: Path, edits: Edits) -> str:
    """``source``'s text with each ``(old, new)`` edit applied."""
    text = source.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{old!r} not in {source.name}")
        text = text.replace(old, new)
    return text


def build_all(source: Path, out: Path, variants: Dict[str, Edits]) -> None:
    """``out/<variant>.so`` for every variant, all nvcc runs started
    together."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(source, edits))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def main(script: str, doc: str, source: Path, out: Path,
         variants: Dict[str, Edits], time_variant: Callable[[str, int], None],
         calls: int) -> int:
    """The command line of a stage script: with ``--variant`` time that
    built library; without, print the card's name and power limit, build
    every variant and time each in a process of its own, twice."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--calls", type=int, default=calls)
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variant:
        time_variant(args.variant, args.calls)
        return 0
    import torch
    if not torch.cuda.is_available():
        print(f"{Path(script).stem}: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build_all(source, out, variants)
    order = list(variants)
    for names in (order, order[::-1]):
        for name in names:
            subprocess.run([sys.executable, script, "--variant", name,
                            "--calls", str(args.calls)], check=True,
                           timeout=600)
    return 0
