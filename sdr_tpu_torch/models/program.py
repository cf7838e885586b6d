"""Block programs: a streaming step captured once per shape as a CUDA graph.

The counterpart of the JAX package's compiled-program layer: the jitted
``_block_step`` behind ``make_block_fn`` (its state donated),
``run_blocks_scan``'s scan, the channelizer's jitted ``_channelize_block``
and the time-sharded step and scans (``sdr_tpu/models/receiver.py``,
``models/channelizer.py``, ``parallel/time_shard.py``).  A :class:`Program`
wraps a streaming step ``step(x, params, state) -> (out, state)``; on a
CUDA device it captures the step as a ``torch.cuda.CUDAGraph`` the first
time it sees a shape, then replays it: one host launch a block where the
eager step makes about 140.  Its scan form, :meth:`Program.scan`, captures
K chained steps as one graph (a chunk graph): one host launch per K
blocks.

Contract, the JAX form's:

* ``program(x, params, state) -> (out, state)``: the outputs and the new
  state are ``step``'s on the same inputs, bit for bit.
* ``program.scan(xs, params, state) -> (outs, state)``: ``xs`` is (K, ...,
  block); the outputs, stacked (K, ..., out), and the final state are those
  of K chained calls, bit for bit.  Inside the graph step k's new state is
  step k+1's input, and step k's outputs are copied into slot k of stacked
  output buffers, so its intermediates are freed for step k+1 and the pool
  grows with K by the stacked outputs only.  The final state goes into the
  same state buffers as a call's, so calls and scans interleave on one
  stream of blocks.  The static input holds the K blocks with the block
  stride rounded up to 16 bytes (:func:`block_stride`), so every block's
  view starts where the kernels' bulk copies need it; a host ``xs`` reaches
  it through pinned staging.
* The state is donated.  The program keeps one set of state buffers per
  state signature (leaf shapes and types); the graph writes the new state
  into them in place and the call returns them as the state.  A state that
  is not those buffers (a fresh ``init_state``, one loaded from a
  checkpoint) is copied into them first and is itself left as it was; the
  program's own buffers, passed back, are overwritten by the call, as a
  donated JAX buffer is consumed.  Clone a state to keep it.
* ``params`` (coefficients, never written) are read from the program's own
  buffers.  A call with other tensors, or with the same ones changed in
  place (their version counter moved), copies them in, so a graph never
  reads stale coefficients.
* ``x`` is copied into the graph's static input, from the device or from
  host memory (without blocking from pinned memory).
* ``out`` is copied out of the graph's buffers on the current stream, so a
  later call never changes a tensor a caller holds.

One graph per key: input shape and type, device, and the signatures of the
params and the state (the step's static switches are fixed when the program
is made), and for a scan its K.  Before a capture the step runs once eagerly on a side stream, on
copies of the state buffers, so that it never advances the caller's stream
of blocks; that run builds the kernels (``kernels.build``), fills the caches
a block reads by address (``ops.fir._maps_on``, ``ops.pll.loop_constants``,
``ops.pll_cuda``'s lane constants and breakpoints) or uses once per layout
(``ops.fir_decim._recipes``), and sets the kernels' shared-memory
attributes (``csrc/fir_decim.cu``, ``csrc/pll.cu``), none of which may
happen under capture.  The graphs of one program share one memory pool
and one side stream a device.  A capture that fails raises, in PyTorch's
default (global) capture-error mode, and so does a replay: nothing on the
card falls back to the eager step.

The kernel wrappers count a launch when their kernel is launched; the
capture records them, so each replay adds its graph's launches to the
same counts (``COUNTED``): a chunk graph's replay adds K blocks' launches.

While a ``torch.profiler`` profile records, each call marks its stages
as sibling spans (``utils.profiling.span``): ``sdr.program.inputs`` (the
key, the params' versions, the state slot and a foreign state's copy),
``sdr.program.capture`` (a new key's entry, warm-up and capture),
``sdr.program.staging_wait`` and ``sdr.program.stage`` (a host scan input
on the card), ``sdr.program.load``, ``sdr.program.replay`` and
``sdr.program.copy_out``.  No span lies inside the step, which a graph
replays without host code.

On the CPU the bookkeeping is the same with the capture replaced by a
direct call of ``step`` on the static buffers (K chained calls for a
scan): keys, copy-in of params, input and a foreign state, donation into
the state buffers and copy-out, so the CPU tests exercise everything but
the graph.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, NamedTuple

import torch

from sdr_tpu_torch.ops import fir_decim, fir_frontend, pll_cuda
from sdr_tpu_torch.utils.profiling import span

#: the kernel wrappers whose launches a graph holds (each has a
#: ``launches`` count); K6 runs outside the graphs, once per call
COUNTED = (fir_frontend.fir_frontend_u8,
           fir_frontend.fir_frontend_u8_deinterleaved,
           fir_decim.fir_block_decim, pll_cuda.pll_angles,
           pll_cuda.pll_mixer)

#: what every program of the process did: eager warm-up runs, graph
#: captures, graph replays (direct calls on the CPU; one per call or scan)
#: and the blocks those replays ran (K per scan)
counts = {"warm_ups": 0, "captures": 0, "replays": 0, "blocks": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


# --- trees of tensors (NamedTuples, nested; a bare tensor is one leaf) ----


def tree_leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_build(template, leaves: list):
    """``template``'s structure with ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, tuple):
            subs = [build(s) for s in t]
            return type(t)(*subs) if hasattr(t, "_fields") else tuple(subs)
        return next(it)
    return build(template)


def tree_map(fn: Callable, tree):
    return tree_build(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def _signature(leaves: list) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


def _version(t: torch.Tensor):
    """The in-place version counter, or None where there is none
    (inference tensors): then the tensor is copied in every call."""
    return None if t.is_inference() else t._version


def copy_leaves(dst: list, src: list) -> None:
    """``dst[i] <- src[i]`` for each non-empty pair that is not one tensor,
    as one multi-tensor copy (a few launches for the ~30 leaves of a
    receiver state).  A source that shares memory with a destination is
    cloned first, so that no copy reads what another one wrote."""
    owned = {d.untyped_storage().data_ptr() for d in dst if d.numel()}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in owned
              else s) for d, s in zip(dst, src) if s is not d and s.numel()]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs],
                             non_blocking=True)


def copy_out(tree):
    """Fresh tensors holding ``tree``'s values, in one multi-tensor
    copy."""
    leaves = tree_leaves(tree)
    fresh = [torch.empty_like(t) for t in leaves]
    copy_leaves(fresh, leaves)
    return tree_build(tree, fresh)


class _Slot:
    """A program's buffers for one signature of params or state."""

    def __init__(self, template, device: torch.device):
        self.bufs = [torch.empty(t.shape, dtype=t.dtype, device=device)
                     for t in tree_leaves(template)]
        self.tree = tree_build(template, self.bufs)
        self.seen: list | None = None    # params: (tensor, version) copied


class CaptureRecord(NamedTuple):
    """One graph's capture: its block shape and type, device, the blocks it
    runs (K of a scan, 1 for a call), the eager warm-up's and the capture's
    seconds (host clock around a synchronize), the bytes still allocated
    after the capture (the graph's outputs and what it keeps alive) and the
    bytes its memory pool reserved."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device
    blocks: int
    warm_up_s: float
    capture_s: float
    allocated_bytes: int
    pool_bytes: int


def block_stride(shape: tuple, dtype: torch.dtype) -> int:
    """Elements from one block to the next in a scan's static input: the
    block's size rounded up to 16 bytes, so that every block's view starts
    16-byte aligned, as a block at an allocation's base does (the bulk
    copies of ``csrc/bulk_copy.cuh``)."""
    size = torch.empty((), dtype=dtype).element_size()
    return -(-math.prod(shape) * size // 16) * 16 // size


def _blocks_buffer(k: int, shape: tuple, dtype: torch.dtype,
                   device: torch.device, pin: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat storage, (k,) + shape view) of k blocks ``block_stride``
    apart; each block's view is contiguous."""
    stride = block_stride(shape, dtype)
    flat = torch.empty(k * stride, dtype=dtype, device=device, pin_memory=pin)
    inner = torch.empty(shape, dtype=dtype, device="meta").stride()
    return flat, flat.as_strided((k,) + tuple(shape), (stride,) + inner)


class _Entry:
    """One key's static input, graph outputs and run function; ``blocks``
    is K for a scan's entry (its input (K, ...) with the padded block
    stride), None for a call's."""

    def __init__(self, shape: tuple, dtype: torch.dtype,
                 device: torch.device, blocks: int | None):
        self.blocks = blocks
        if blocks is None:
            self.x = self.flat = torch.empty(shape, dtype=dtype,
                                             device=device)
        else:
            self.flat, self.x = _blocks_buffer(blocks, shape, dtype, device)
        self.staging = None     # a scan's pinned (flat, view, event)
        self.out = None
        self.run: Callable[[], None] | None = None

    def load(self, x: torch.Tensor) -> None:
        """``x`` into the static input.  A host input of a scan on the card
        goes through pinned staging: one host copy into the padded layout,
        one asynchronous copy to the card; the staging is refilled only
        after its previous copy to the card has finished."""
        if x is self.x:
            return
        if self.blocks is None or not self.x.is_cuda or x.is_cuda:
            with span("sdr.program.load"):
                self.x.copy_(x, non_blocking=True)
            return
        if self.staging is None:
            flat, view = _blocks_buffer(self.blocks, self.x.shape[1:],
                                        self.x.dtype, "cpu", pin=True)
            self.staging = (flat, view, torch.cuda.Event())
        else:
            with span("sdr.program.staging_wait"):
                self.staging[2].synchronize()
        flat, view, done = self.staging
        with span("sdr.program.stage"):
            view.copy_(x)
        with span("sdr.program.load"):
            self.flat.copy_(flat, non_blocking=True)
            done.record(torch.cuda.current_stream(self.x.device))


class Program:
    """``step(x, params, state) -> (out, state)`` captured per shape and
    replayed (see the module docstring for the contract).  ``switches``
    name the step's static arguments; they are part of every key."""

    def __init__(self, step: Callable, switches: tuple = ()):
        self.step = step
        self.switches = switches
        self._entries: dict[tuple, _Entry] = {}
        self._params: dict[tuple, _Slot] = {}
        self._states: dict[tuple, _Slot] = {}
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._pools: dict[torch.device, tuple] = {}
        self.captures: list[CaptureRecord] = []

    def keys(self) -> list[tuple]:
        """One key per captured graph (per direct-call entry on the CPU)."""
        return list(self._entries)

    def __call__(self, x: torch.Tensor, params, state):
        return self._run(x, params, state, None)

    def scan(self, xs: torch.Tensor, params, state):
        """K = ``xs.shape[0]`` chained blocks as one graph (see the module
        docstring): outputs stacked (K, ..., out) and the state."""
        return self._run(xs, params, state, xs.shape[0])

    def replay(self, key: tuple) -> None:
        """Run the graph of ``key`` (one of :meth:`keys`) once more on its
        static buffers as they stand: the state carries on in the state
        buffers and the outputs land in the graph's buffers, with nothing
        copied in or out.  What a step's own time is measured on
        (``scripts/torch_profile_stages.py``)."""
        entry = self._entries[key]
        with span("sdr.program.replay"):
            entry.run()
        counts["replays"] += 1
        counts["blocks"] += entry.blocks or 1

    def _run(self, x: torch.Tensor, params, state, blocks: int | None):
        # the spans (utils.profiling.span) are siblings: a new key's load
        # lies inside its capture
        with span("sdr.program.inputs"):
            p_leaves, s_leaves = tree_leaves(params), tree_leaves(state)
            dev = p_leaves[0].device
            shape = tuple(x.shape) if blocks is None else tuple(x.shape[1:])
            key = (shape, x.dtype, dev, _signature(p_leaves),
                   _signature(s_leaves), self.switches)
            if blocks is not None:
                key += (blocks,)
            params_slot = self._params_in(dev, params, p_leaves)
            state_slot = self._slot(self._states, dev, state, s_leaves)
            copy_leaves(state_slot.bufs, s_leaves)
            entry = self._entries.get(key)
        fresh = entry is None
        try:
            if fresh:
                with span("sdr.program.capture"):
                    entry = self._entries[key] = _Entry(shape, x.dtype, dev,
                                                        blocks)
                    entry.load(x)
                    entry.run = self._capture(entry, params_slot, state_slot)
            else:
                entry.load(x)
            with span("sdr.program.replay"):
                entry.run()
        except BaseException:
            if fresh:
                self._entries.pop(key, None)
            raise
        counts["replays"] += 1
        counts["blocks"] += blocks or 1
        with span("sdr.program.copy_out"):
            out = copy_out(entry.out)
        return out, state_slot.tree

    @staticmethod
    def _slot(slots: dict, dev: torch.device, tree, leaves: list) -> _Slot:
        key = (dev, _signature(leaves))
        slot = slots.get(key)
        if slot is None:
            slot = slots[key] = _Slot(tree, dev)
        return slot

    def _params_in(self, dev: torch.device, params, leaves: list) -> _Slot:
        slot = self._slot(self._params, dev, params, leaves)
        seen = [(t, _version(t)) for t in leaves]
        if slot.seen is None or any(
                t is not s or v is None or v != sv
                for (t, v), (s, sv) in zip(seen, slot.seen)):
            copy_leaves(slot.bufs, leaves)
            slot.seen = seen
        return slot

    def _body(self, entry: _Entry, params: _Slot, state: _Slot) -> None:
        """The step on the static buffers, the new state donated into the
        state buffers; the outputs stay where the step put them."""
        out, new = self.step(entry.x, params.tree, state.tree)
        copy_leaves(state.bufs, tree_leaves(new))
        entry.out = out

    def _scan_body(self, entry: _Entry, params: _Slot, state: _Slot
                   ) -> None:
        """K chained steps on the static buffers: step k's outputs copied
        into slot k of the stacked outputs (made at the first step), its
        new state handed to step k+1, the last one donated into the state
        buffers."""
        st = state.tree
        for k in range(entry.blocks):
            out, st = self.step(entry.x[k], params.tree, st)
            if entry.out is None:
                entry.out = tree_map(
                    lambda t: t.new_empty((entry.blocks,) + tuple(t.shape)),
                    out)
            copy_leaves([o[k] for o in tree_leaves(entry.out)],
                        tree_leaves(out))
            del out
        copy_leaves(state.bufs, tree_leaves(st))

    def _direct(self, entry: _Entry, params: _Slot, state: _Slot) -> None:
        """The CPU's replay: :meth:`_body`, its outputs then copied into
        the entry's fixed output buffers, which every call overwrites as a
        graph's replay overwrites its outputs (a scan's stacked outputs are
        such buffers already)."""
        if entry.blocks is not None:
            self._scan_body(entry, params, state)
            return
        fixed = entry.out
        self._body(entry, params, state)
        if fixed is None:
            fixed = tree_map(torch.empty_like, entry.out)
        copy_leaves(tree_leaves(fixed), tree_leaves(entry.out))
        entry.out = fixed

    def _capture(self, entry: _Entry, params: _Slot,
                 state: _Slot) -> Callable[[], None]:
        """The function that runs ``entry``'s block (its K blocks): on the
        CPU direct calls of the step, on the card the replay of a graph
        captured here."""
        dev = entry.x.device
        if dev.type != "cuda":
            return lambda: self._direct(entry, params, state)
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.device(dev):
            t0 = time.perf_counter()
            # warm-up: eager, one block, on the side stream, on copies of
            # the state
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                warm = tree_build(state.tree, [b.clone() for b in state.bufs])
                self.step(entry.x if entry.blocks is None else entry.x[0],
                          params.tree, warm)
                del warm
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            counts["warm_ups"] += 1
            t1 = time.perf_counter()
            torch.cuda.empty_cache()
            alloc0 = torch.cuda.memory_allocated(dev)
            res0 = torch.cuda.memory_reserved(dev)
            before = [f.launches for f in COUNTED]
            graph = torch.cuda.CUDAGraph()
            pool = self._pools.get(dev)
            if pool is None:
                pool = self._pools[dev] = torch.cuda.graph_pool_handle()
            # no garbage collection inside the capture: a graph freed there
            # (another program's, left in a reference cycle) would destroy
            # its executable while this stream captures, which the global
            # capture mode refuses, invalidating the capture
            was_enabled = gc.isenabled()
            gc.disable()
            try:
                body = (self._body if entry.blocks is None
                        else self._scan_body)
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    body(entry, params, state)
            finally:
                if was_enabled:
                    gc.enable()
            # the capture launched nothing: each replay counts its launches
            added = []
            for f, n0 in zip(COUNTED, before):
                added.append((f, f.launches - n0))
                f.launches = n0
            torch.cuda.synchronize(dev)
            counts["captures"] += 1
            self.captures.append(CaptureRecord(
                tuple(entry.x.shape[entry.blocks is not None:]),
                entry.x.dtype, dev, entry.blocks or 1, t1 - t0,
                time.perf_counter() - t1,
                torch.cuda.memory_allocated(dev) - alloc0,
                torch.cuda.memory_reserved(dev) - res0))

        def replay() -> None:
            graph.replay()
            for f, n in added:
                f.launches += n
        return replay
