"""Faults planted underneath the timed path, for the tests that see
``correct`` come out false and for ``calibrate.py --fault``; no run of
the benchmark plants one.

Each fault is a function ``plant(monkeypatch, mix)`` that breaks the
port where it runs (the block step every program replays, or the
program's call that carries the state from one replay to the next):

- ``state_unchanged``: a step that returns its state unchanged;
- ``half_batch``: half of the batch left out, its rows given the other
  half's outputs;
- ``sample_altered``: one sample of each block's mono arm, an arm that no
  PLL feeds;
- ``answer_altered``: the first channel's RDS symbols, an arm downstream
  of a PLL, scaled by 1 + 1e-3;
- ``rds_pll_reset`` and ``pilot_pll_reset``: one PLL's carried state
  dropped (put back to its start) once, at the call that begins at the
  ring's first wrap, which in a monitor is also a chunk boundary of
  ``iter_run``: the state handed across that boundary, and nothing else;
- ``pilot_sign_flip``: once a block, in every channel, the pilot PLL's
  input negated at the sample where its magnitude is largest: a decision
  taken the other way, as float32 may take one where the input is near
  zero, but at a sample that no rounding can flip.

:func:`pilot_input_hook` is also how ``calibrate.py`` reads the program's
own pilot input.
"""

from __future__ import annotations

import torch


def _step_fault(wrap):
    def plant(monkeypatch, mix):
        from sdr_tpu_torch.models import receiver
        monkeypatch.setattr(receiver, "process_block",
                            wrap(receiver.process_block))
    return plant


def _state_unchanged(step):
    def broken(iq, coeffs, state, *a, **k):
        out, _ = step(iq, coeffs, state, *a, **k)
        return out, state
    return broken


def _half_batch(step):
    from sdr_tpu_torch.models import receiver

    def broken(iq, coeffs, state, *a, **k):
        out, new = step(iq, coeffs, state, *a, **k)
        half = iq.shape[0] // 2
        return receiver.BlockOutputs(*[
            arm if arm.dim() < 2 or arm.shape[-1] == 0
            else arm.clone().index_copy_(
                0, torch.arange(half, iq.shape[0], device=arm.device),
                arm[:half])
            for arm in out]), new
    return broken


def _sample_altered(step):
    def broken(iq, coeffs, state, *a, **k):
        out, new = step(iq, coeffs, state, *a, **k)
        mono = out.mono.clone()
        mono[..., 7] += 1e-3
        return out._replace(mono=mono), new
    return broken


def _answer_altered(step):
    def broken(iq, coeffs, state, *a, **k):
        out, new = step(iq, coeffs, state, *a, **k)
        sym = out.rds_symbols.clone()
        sym.view(-1, sym.shape[-1])[0] *= 1.0 + 1e-3
        return out._replace(rds_symbols=sym), new
    return broken


def _pll_reset(field: str):
    """The program's call (one replay: a block, or a chunk graph of
    blocks) that begins at stream block ``ring_blocks`` gets ``field``'s
    PLL state put back to its start.  A stream begins where a state that
    the program did not return comes in (the drivers' fresh state)."""
    def plant(monkeypatch, mix):
        from sdr_tpu_torch.models import program, receiver
        at = mix["ring_blocks"]
        run = program.Program._run
        seen: dict[int, tuple] = {}

        def broken(self, x, params, state, blocks):
            last = seen.get(id(self))
            pos = last[1] if last is not None and state is last[0] else 0
            if pos == at:
                lead = state.rf_i.shape[:-1]
                start = receiver.init_state(self.switches[0], lead,
                                            device=state.rf_i.device)
                state = state._replace(**{field: getattr(start, field)})
            out, new = run(self, x, params, state, blocks)
            seen[id(self)] = (new, pos + (blocks or 1))
            return out, new
        monkeypatch.setattr(program.Program, "_run", broken)
    return plant


def pilot_input_hook(monkeypatch, fn) -> None:
    """Every call of the port's PLL kernels (K3's and K2's wrappers,
    which every path of the block step calls) hands its pilot PLL's input
    (..., N) to ``fn`` and runs on what ``fn`` returns."""
    from sdr_tpu_torch import config
    from sdr_tpu_torch.ops import pll_cuda

    def wrap(kernel):
        def hooked(x, *args):
            for k, p in enumerate(args[-1]):
                if p.freq == config.PILOT_FREQ_HZ:
                    xk = x[..., k, :]
                    y = fn(xk)
                    if y is not xk:
                        x = x.clone()
                        x[..., k, :] = y
            return kernel(x, *args)
        return hooked
    for name in ("pll_mixer_fused_kernel", "pll_block_fused_kernel"):
        monkeypatch.setattr(pll_cuda, name, wrap(getattr(pll_cuda, name)))


def _flip_largest(x: torch.Tensor) -> torch.Tensor:
    at = x.abs().argmax(dim=-1, keepdim=True)
    return x.scatter(-1, at, -x.gather(-1, at))


def _pilot_sign_flip(monkeypatch, mix):
    pilot_input_hook(monkeypatch, _flip_largest)


FAULTS = {
    "state_unchanged": _step_fault(_state_unchanged),
    "half_batch": _step_fault(_half_batch),
    "sample_altered": _step_fault(_sample_altered),
    "answer_altered": _step_fault(_answer_altered),
    "rds_pll_reset": _pll_reset("rds_pll"),
    "pilot_pll_reset": _pll_reset("pilot_pll"),
    "pilot_sign_flip": _pilot_sign_flip,
}
