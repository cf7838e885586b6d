"""What the port's robustness and long-capture studies share
(``scripts/torch_snr_matrix.py``, ``torch_rds_drift_matrix.py``,
``torch_overlap_convergence.py``, ``torch_long_capture_demo.py``): the
repository on the path, the ``--device`` and ``--out`` options, the
device record every artifact carries, and writing the artifact.

A study runs on ``cuda`` by default and raises without a card; ``--device
cpu`` runs it on the CPU and then writes under ``build/studies/``, never
over the card's artifact in ``docs/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: docs/<name> on the card, "
                         "build/studies/<name> on the CPU)")
    return ap


def device_record(device) -> dict:
    """The device a study ran on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (None on the CPU), and the torch and CUDA versions."""
    import torch

    dev = torch.device(device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"device": str(dev), "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def write(name: str, device, out: str | None, record: dict) -> str:
    """``record`` as JSON at ``out`` or the default place for ``device``."""
    import torch

    if out is None:
        where = "docs" if torch.device(device).type == "cuda" else \
            os.path.join("build", "studies")
        out = os.path.join(ROOT, where, name)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    print(f"wrote {out}")
    return out
