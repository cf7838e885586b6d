"""Helpers of the port's multi-process tests.  Imports no jax: the card
tests (tests/test_torch_cuda.py, run with ``--noconftest`` on a machine
without jax) use it too."""

import importlib.util
from pathlib import Path

import torch.distributed as dist

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" \
    / "torch_multihost_scaling.py"


def load_scaling():
    """``scripts/torch_multihost_scaling.py``, loaded as a module."""
    spec = importlib.util.spec_from_file_location("torch_multihost_scaling",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loopback_group(monkeypatch, backend: str) -> list:
    """Replace the ``torch.distributed`` group by a loopback of ``backend``
    that copies each send into the receive of the same tag.  Returns the
    list into which every (op, tensor, peer, tag) handed to the group is
    recorded."""
    seen = []
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "P2POp", lambda op, t, peer, tag=0:
                        seen.append((op, t, peer, tag)) or seen[-1])

    def batch_isend_irecv(ops):
        sent = {tag: t for op, t, _, tag in ops if op is dist.isend}
        for op, t, _, tag in ops:
            if op is dist.irecv:
                t.copy_(sent[tag])
        return []

    monkeypatch.setattr(dist, "batch_isend_irecv", batch_isend_irecv)
    return seen
