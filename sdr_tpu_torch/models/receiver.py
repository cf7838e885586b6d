"""FM receiver in PyTorch: one function per block, a loop over blocks.

Port of ``sdr_tpu/models/receiver.py``.  The per-block DAG

    RF front-end -> mono || stereo || RDS-DSP

is one function, :func:`process_block`, over an explicit state tuple, with
the JAX package's contracts and layouts: time last, channel batch dims
leading, the same ``NamedTuple`` fields in the same order.  Streaming over a
recording is a Python loop over blocks (:class:`Receiver`).  The symbol-rate
RDS decode runs on the host (``sdr_tpu_torch.models.rds_decode``).

Kernels: the RF front-end is kernel K1 (``ops.fir_frontend``) on raw u8
input and K5 (``ops.fir_decim``) on float input, as the channelizer feeds
it; the two carrier-recovery PLLs run on K2 or K3 (``ops.pll_cuda``).
There is one path: each kernel wrapper launches its
kernel on a CUDA tensor and runs its plain version on a CPU tensor, which
is the JAX package's ``auto_kernel_selectors`` decision made by device.
Everything else is plain PyTorch, as it was XLA in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch.golden import filters as gfilt
from sdr_tpu_torch.ops import demod as tdemod
from sdr_tpu_torch.ops import fir as tfir
from sdr_tpu_torch.ops import fir_decim, fir_frontend
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.ops import pll_cuda

_F32 = torch.float32


class ReceiverCoeffs(NamedTuple):
    """All FIR coefficient sets of one mode, designed on the host in float64
    and stored as float32 tensors."""

    rf: torch.Tensor
    audio: torch.Tensor
    pilot: torch.Tensor
    stereo: torch.Tensor
    rds_channel: torch.Tensor
    rds_carrier: torch.Tensor
    rds_resampler: torch.Tensor
    rds_rrc: torch.Tensor


class ReceiverState(NamedTuple):
    """Inter-block carry; every leaf may carry leading batch dims.

    ``stereo_bpf``/``pilot_bpf``/``rds_channel`` are overlap-save tails of
    the same ``fm`` signal, so the fused three-band path reads only
    ``stereo_bpf`` and writes the one shared tail into all three."""

    rf_i: torch.Tensor
    rf_q: torch.Tensor
    demod_iq: torch.Tensor
    mono_allpass: torch.Tensor
    mono_fir: torch.Tensor
    stereo_bpf: torch.Tensor
    pilot_bpf: torch.Tensor
    stereo_fir: torch.Tensor
    pilot_pll: tpll.PllState
    rds_channel: torch.Tensor
    rds_allpass: torch.Tensor
    rds_carrier: torch.Tensor
    rds_pll: tpll.PllState
    rds_resampler: torch.Tensor
    rds_rrc: torch.Tensor
    rds_resampler_q: torch.Tensor
    rds_rrc_q: torch.Tensor


class BlockOutputs(NamedTuple):
    """Per-block outputs.  Disabled arms are zero-length tensors."""

    fm_demod: torch.Tensor
    mono: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    rds_symbols: torch.Tensor    # RRC output (soft symbols at SPS*2375)
    rds_symbols_q: torch.Tensor  # quadrature debug arm


def design_coeffs(mc: cfg.ModeConfig, dtype: torch.dtype = _F32,
                  device: torch.device | str | None = None
                  ) -> ReceiverCoeffs:
    """Design every filter for one mode (host float64 -> ``dtype``)."""
    r = mc.rds
    f = lambda a: torch.tensor(a, dtype=dtype, device=device)
    z = torch.zeros((0,), dtype=dtype, device=device)
    return ReceiverCoeffs(
        rf=f(gfilt.lowpass_taps(mc.rf_taps, mc.rf_fs, cfg.RF_FC_HZ)),
        audio=f(gfilt.lowpass_taps(mc.audio_taps, mc.audio_lpf_fs,
                                   cfg.AUDIO_FC_HZ)),
        pilot=f(gfilt.bandpass_taps(mc.stereo_taps, mc.if_fs,
                                    *cfg.PILOT_BPF_HZ)),
        stereo=f(gfilt.bandpass_taps(mc.stereo_taps, mc.if_fs,
                                     *cfg.STEREO_BPF_HZ)),
        rds_channel=(f(gfilt.bandpass_taps(mc.rds_taps, mc.if_fs,
                                           *cfg.RDS_CHANNEL_BPF_HZ))
                     if r else z),
        rds_carrier=(f(gfilt.bandpass_taps(mc.rds_taps, mc.if_fs,
                                           *cfg.RDS_CARRIER_BPF_HZ))
                     if r else z),
        rds_resampler=(f(gfilt.lowpass_taps(r.resampler_taps,
                                            mc.if_fs * r.upsamp,
                                            cfg.RDS_RESAMPLER_FC_HZ))
                       if r else z),
        rds_rrc=f(gfilt.rrc_taps(r.symbol_fs, r.rrc_taps)) if r else z,
    )


def init_state(mc: cfg.ModeConfig, batch_shape: tuple[int, ...] = (),
               dtype: torch.dtype = _F32,
               device: torch.device | str | None = None) -> ReceiverState:
    """Zero state; ``batch_shape`` prepends channel batch dims to every
    leaf."""
    r = mc.rds
    z = lambda *s: torch.zeros(tuple(batch_shape) + tuple(s), dtype=dtype,
                               device=device)

    def pll0(nco_q_last: float = 0.0) -> tpll.PllState:
        st = tpll.pll_init(nco_q_last=nco_q_last, dtype=dtype, device=device)
        return tpll.PllState(*[leaf.expand(tuple(batch_shape)).clone()
                               for leaf in st])

    audio_state = (gfilt.resample_state_len(mc.audio_taps, mc.audio_upsamp)
                   if mc.audio_upsamp > 1 else mc.audio_taps - 1)
    rs_len = (gfilt.resample_state_len(r.resampler_taps, r.upsamp)
              if r else 0)
    return ReceiverState(
        rf_i=z(mc.rf_taps - 1),
        rf_q=z(mc.rf_taps - 1),
        demod_iq=z(2),
        mono_allpass=z((mc.stereo_taps - 1) // 2),
        mono_fir=z(audio_state),
        stereo_bpf=z(mc.stereo_taps - 1),
        pilot_bpf=z(mc.stereo_taps - 1),
        stereo_fir=z(audio_state),
        pilot_pll=pll0(),
        rds_channel=z(mc.rds_taps - 1) if r else z(0),
        rds_allpass=z((mc.rds_taps - 1) // 2) if r else z(0),
        rds_carrier=z(mc.rds_taps - 1) if r else z(0),
        # the reference RDS PLL state is [0,0,1,0,1,0,1]: nco_q[0] carries
        # 1.0, unlike the stereo PLL's 0.0
        rds_pll=pll0(nco_q_last=1.0),
        rds_resampler=z(rs_len),
        rds_rrc=z(r.rrc_taps - 1) if r else z(0),
        rds_resampler_q=z(rs_len),
        rds_rrc_q=z(r.rrc_taps - 1) if r else z(0),
    )


def validate_u8_rf_state(rf_i, rf_q) -> None:
    """Host-side guard for the u8 state-dtype contract.

    A carried RF tail that came from raw u8 input (or the zero init) holds
    only values k/128 for integer k in [-128, 127].  Raises ValueError when
    a tail is not of that form, i.e. it was produced from float input and
    would not be resumable as a u8 stream in the JAX package, whose u8
    front-end turns the tail back into bytes."""
    for name, tail in (("rf_i", rf_i), ("rf_q", rf_q)):
        if isinstance(tail, torch.Tensor):
            tail = tail.detach().cpu().numpy()
        t = np.asarray(tail, np.float64) * 128.0
        # +128 (state exactly +1.0) is not byte-representable
        if not (np.all(t == np.round(t)) and np.all(t >= -128)
                and np.all(t <= 127)):
            bad = float(np.max(np.abs(t - np.round(t))))
            raise ValueError(
                f"RF tail state '{name}' is not 1/128-quantized (max "
                f"fractional residue {bad:.3g}/128): it was produced from "
                "float input, so it cannot resume a raw-u8 stream.  Feed "
                "float input, or re-create the state from the u8 path.")


def pilot_pll_params(mc: cfg.ModeConfig) -> tpll.PllParams:
    """Stereo pilot PLL: 19 kHz, x2 NCO, bandwidth 0.01."""
    return tpll.PllParams(freq=cfg.PILOT_FREQ_HZ, fs=mc.if_fs, nco_scale=2.0,
                          phase_adjust=0.0, norm_bandwidth=0.01)


def rds_pll_params(mc: cfg.ModeConfig) -> tpll.PllParams:
    """RDS carrier PLL: 114 kHz, x0.5 NCO, +3pi/8, bandwidth 0.002."""
    return tpll.PllParams(freq=cfg.RDS_CARRIER_FREQ_HZ, fs=mc.if_fs,
                          nco_scale=0.5, phase_adjust=3.0 * np.pi / 8.0,
                          norm_bandwidth=0.002)


def _audio_fir(x, h, state, mc: cfg.ModeConfig):
    if mc.audio_upsamp > 1:
        return tfir.fir_block_resample_mm(x, h, state, mc.audio_decim,
                                          mc.audio_upsamp)
    return tfir.fir_block_decim_mm(x, h, state, mc.audio_decim)


def _fir_unit(x, h, state):
    return tfir.fir_block_decim_mm(x, h, state, 1)


#: lane product (channels x PLL arms) at and above which the mixer-fused
#: PLL kernel is used (the JAX package's measured policy, kept unchanged)
_FUSED_MIXER_MIN_LANES = 1024


def fused_mixer_policy(batch: int, arms: int) -> bool:
    """The shape policy ``process_block`` applies when ``fused_mixer`` is
    None: the mixer-fused PLL (K3) for one arm or for at least 1024 lanes,
    the angle kernel (K2) otherwise.  The same decision as the JAX package
    at every shape."""
    return arms == 1 or batch * arms >= _FUSED_MIXER_MIN_LANES


def process_block(iq: torch.Tensor, coeffs: ReceiverCoeffs,
                  state: ReceiverState, mc: cfg.ModeConfig,
                  stereo: bool = True, with_rds: bool = False,
                  rds_debug_q: bool = False,
                  fused_mixer: bool | None = None
                  ) -> tuple[BlockOutputs, ReceiverState]:
    """One block of the receiver DAG (pure: the inputs are not modified).

    ``iq`` is interleaved I,Q,... of shape (..., 2*N_rf): raw uint8 straight
    off the SDR, or normalized float32.  Leading dims are an
    independent-channel batch.  Raw u8 input goes through K1 and float
    input through K5; the PLLs run
    on K3 when ``fused_mixer`` (default: :func:`fused_mixer_policy`) says so
    and on K2 otherwise.  On CPU tensors the wrappers run the kernels'
    plain versions.
    """
    s = state
    upd: dict = {}
    empty = torch.zeros(iq.shape[:-1] + (0,), dtype=_F32, device=iq.device)

    # --- RF front-end --------------------------------------------------
    st2 = torch.stack([s.rf_i, s.rf_q], dim=-2)
    if iq.dtype == torch.uint8:
        ds2, nst2 = fir_frontend.fir_frontend_u8(iq, coeffs.rf, st2,
                                                 mc.rf_decim)
    else:
        # K5 reads I and Q straight from the interleaved block through this
        # (..., 2, N) view (element step 2): no deinterleaved copy
        iq2 = iq.reshape(iq.shape[:-1] + (iq.shape[-1] // 2, 2)).movedim(-1,
                                                                        -2)
        ds2, nst2 = fir_decim.fir_block_decim(iq2, coeffs.rf, st2,
                                              mc.rf_decim)
    i_ds, q_ds = ds2[..., 0, :], ds2[..., 1, :]
    upd["rf_i"], upd["rf_q"] = nst2[..., 0, :], nst2[..., 1, :]
    fm, upd["demod_iq"] = tdemod.fm_demod_quad(i_ds, q_ds, s.demod_iq)

    # --- mono, delay-matched to the band-pass arms ---------------------
    fm_delayed, upd["mono_allpass"] = tfir.allpass_delay(fm, s.mono_allpass)
    if not stereo:
        mono, upd["mono_fir"] = _audio_fir(fm_delayed, coeffs.audio,
                                           s.mono_fir, mc)

    # --- band-pass arms --------------------------------------------------
    rds_on = with_rds and mc.rds is not None
    if stereo and rds_on and mc.rds_taps == mc.stereo_taps:
        # the three band-passes share input and length: one product with
        # the taps side by side; their overlap-save states are one fm tail
        hs = torch.stack([coeffs.stereo, coeffs.pilot, coeffs.rds_channel])
        filt3, tail = tfir.fir_block_multi_mm(fm, hs, s.stereo_bpf)
        st_filt, pi_filt, chan = (filt3[..., 0, :], filt3[..., 1, :],
                                  filt3[..., 2, :])
        upd["stereo_bpf"] = upd["pilot_bpf"] = upd["rds_channel"] = tail
    else:
        if stereo:
            hs = torch.stack([coeffs.stereo, coeffs.pilot])
            filt2, tail = tfir.fir_block_multi_mm(fm, hs, s.stereo_bpf)
            st_filt, pi_filt = filt2[..., 0, :], filt2[..., 1, :]
            upd["stereo_bpf"] = upd["pilot_bpf"] = tail
        if rds_on:
            chan, upd["rds_channel"] = _fir_unit(fm, coeffs.rds_channel,
                                                 s.rds_channel)
    if rds_on:
        r = mc.rds
        chan_delayed, upd["rds_allpass"] = tfir.allpass_delay(chan,
                                                              s.rds_allpass)
        carrier, upd["rds_carrier"] = _fir_unit(chan * chan,
                                                coeffs.rds_carrier,
                                                s.rds_carrier)

    # --- carrier-recovery PLLs and mixers --------------------------------
    if fused_mixer is None:
        nl = math.prod(iq.shape[:-1])
        k_arms = int(stereo) + int(rds_on)
        fused_mixer = fused_mixer_policy(nl, k_arms)
    if fused_mixer and not rds_debug_q and (stereo or rds_on):
        # K3: the NCO arrays never reach device memory; the debug-Q arm
        # needs the quadrature NCO, so it takes the unfused path
        ins, mixes, pars, sts, names = [], [], [], [], []
        if stereo:
            ins.append(pi_filt)
            mixes.append(st_filt)
            pars.append(pilot_pll_params(mc))
            sts.append(s.pilot_pll)
            names.append("pilot_pll")
        if rds_on:
            ins.append(carrier)
            mixes.append(chan_delayed)
            pars.append(rds_pll_params(mc))
            sts.append(s.rds_pll)
            names.append("rds_pll")
        mixers, pll_out = pll_cuda.pll_mixer_fused_kernel(
            torch.stack(ins, dim=-2), torch.stack(mixes, dim=-2),
            tpll.stack_arms(sts), tuple(pars))
        for i, name in enumerate(names):
            upd[name] = tpll.arm(pll_out, i)
        if stereo:
            mixer = mixers[..., 0, :]
        if rds_on:
            rds_mixer = mixers[..., len(names) - 1, :]
    else:
        # K2 emits the angles; the NCOs and mixers are formed here
        if stereo and rds_on:
            pll_in = torch.stack([pi_filt, carrier], dim=-2)   # (..., 2, N)
            ncos, ncos_q, pll_out = pll_cuda.pll_block_fused_kernel(
                pll_in, tpll.stack_arms([s.pilot_pll, s.rds_pll]),
                (pilot_pll_params(mc), rds_pll_params(mc)))
            nco, nco_r = ncos[..., 0, :], ncos[..., 1, :]
            nco_rq = ncos_q[..., 1, :]
            upd["pilot_pll"] = tpll.arm(pll_out, 0)
            upd["rds_pll"] = tpll.arm(pll_out, 1)
        else:
            if stereo:
                nco, _, upd["pilot_pll"] = pll_cuda.pll_block_kernel(
                    pi_filt, s.pilot_pll, pilot_pll_params(mc))
            if rds_on:
                nco_r, nco_rq, upd["rds_pll"] = pll_cuda.pll_block_kernel(
                    carrier, s.rds_pll, rds_pll_params(mc))
        if stereo:
            mixer = nco[..., :-1] * st_filt * 2.0
        if rds_on:
            rds_mixer = nco_r[..., :-1] * chan_delayed * 2.0

    # --- audio ------------------------------------------------------------
    if stereo:
        # mono + stereo share the audio LPF: one call on the stacked pair
        pair = torch.stack([fm_delayed, mixer], dim=-2)
        st_pair = torch.stack([s.mono_fir, s.stereo_fir], dim=-2)
        out2, nst2 = _audio_fir(pair, coeffs.audio, st_pair, mc)
        mono, st_final = out2[..., 0, :], out2[..., 1, :]
        upd["mono_fir"] = nst2[..., 0, :]
        upd["stereo_fir"] = nst2[..., 1, :]
        left = mono + st_final
        right = mono - st_final
    else:
        left = right = empty

    # --- RDS resampler and matched filter ----------------------------------
    if rds_on:
        resampled, upd["rds_resampler"] = tfir.fir_block_resample_mm(
            rds_mixer, coeffs.rds_resampler, s.rds_resampler,
            r.decim, r.upsamp)
        symbols, upd["rds_rrc"] = _fir_unit(resampled, coeffs.rds_rrc,
                                            s.rds_rrc)
        symbols_q = empty
        if rds_debug_q:
            # quadrature debug arm for constellation inspection: the same
            # chain mixed with the Q NCO
            mixer_q = nco_rq[..., :-1] * chan_delayed * 2.0
            res_q, upd["rds_resampler_q"] = tfir.fir_block_resample_mm(
                mixer_q, coeffs.rds_resampler, s.rds_resampler_q,
                r.decim, r.upsamp)
            symbols_q, upd["rds_rrc_q"] = _fir_unit(res_q, coeffs.rds_rrc,
                                                    s.rds_rrc_q)
    else:
        symbols = symbols_q = empty

    new_state = s._replace(**upd)
    out = BlockOutputs(fm_demod=fm, mono=mono, left=left, right=right,
                       rds_symbols=symbols, rds_symbols_q=symbols_q)
    return out, new_state


def map_state(fn, *trees):
    """``fn`` applied leaf by leaf over NamedTuples of tensors of one type
    (a ``ReceiverState`` with its ``PllState`` leaves, or ``BlockOutputs``)."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*[map_state(fn, *leaves)
                                for leaves in zip(*trees)])
    return fn(*trees)


def process_block_channel_chunked(iq: torch.Tensor, coeffs: ReceiverCoeffs,
                                  state: ReceiverState, mc: cfg.ModeConfig,
                                  stereo: bool = True,
                                  with_rds: bool = False,
                                  channel_chunk: int = 512,
                                  **kernel_kw
                                  ) -> tuple[BlockOutputs, ReceiverState]:
    """``process_block`` over a large channel batch as sequential
    sub-batches of ``channel_chunk`` channels.

    Port of the JAX package's function of the same name, which runs a
    C=1024 batch as two 512-channel programs because its per-channel block
    cost is lowest at C~512.  Falls through to ``process_block`` when the
    batch is not a whole number (>1) of chunks; the leading batch dim must
    be 1-D (C,).  ``kernel_kw`` (``fused_mixer``, ``rds_debug_q``) go to
    every chunk, so by default each chunk takes the PLL kernel its own lane
    count selects."""
    lead = iq.shape[:-1]
    if len(lead) != 1 or lead[0] <= channel_chunk \
            or lead[0] % channel_chunk:
        return process_block(iq, coeffs, state, mc, stereo=stereo,
                             with_rds=with_rds, **kernel_kw)
    parts = []
    for c0 in range(0, lead[0], channel_chunk):
        rows = slice(c0, c0 + channel_chunk)
        parts.append(process_block(
            iq[rows], coeffs, map_state(lambda a: a[rows], state), mc,
            stereo=stereo, with_rds=with_rds, **kernel_kw))
    cat = lambda *xs: torch.cat(xs)
    return (map_state(cat, *[o for o, _ in parts]),
            map_state(cat, *[st for _, st in parts]))


def run_blocks(iq_blocks: torch.Tensor, coeffs: ReceiverCoeffs,
               state: ReceiverState, mc: cfg.ModeConfig, stereo: bool = True,
               with_rds: bool = False, fused_mixer: bool | None = None
               ) -> tuple[BlockOutputs, ReceiverState]:
    """Stream blocks through :func:`process_block`: the counterpart of the
    JAX package's ``run_blocks_scan``, a Python loop where JAX scans.

    ``iq_blocks`` is (n_blocks, ..., block_len): the block axis first, then
    optional channel-batch dims.  Returns the outputs stacked
    (n_blocks, ..., out_len) and the final state.  ``fused_mixer`` pins the
    PLL kernel for every block (None: ``process_block``'s shape policy)."""
    outs = []
    for b in range(iq_blocks.shape[0]):
        out, state = process_block(iq_blocks[b], coeffs, state, mc,
                                   stereo=stereo, with_rds=with_rds,
                                   fused_mixer=fused_mixer)
        outs.append(out)
    return map_state(lambda *arm: torch.stack(arm), *outs), state


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device on a machine without one, so that nothing quietly runs on the
    CPU that the caller did not ask for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "available: pass device='cpu' to run on the CPU")
    return dev


def pin_fp32_matmul() -> None:
    """Turn TF32 off for matrix products and convolutions.  The FIRs need
    full fp32: TF32 keeps ~1e-3 relative precision, where the JAX package's
    FIRs hold ~1.5e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Receiver:
    """Stateful wrapper: owns coeffs + running state on one device.

    ``process(iq)`` consumes one block; ``run(iq)`` a whole recording.  The
    state is exposed for checkpoint/resume (``sdr_tpu_torch.convert``).
    ``device`` defaults to the card; without one it raises
    (:func:`resolve_device`) unless ``device="cpu"`` is passed.  Creating
    one turns TF32 off (:func:`pin_fp32_matmul`).
    """

    def __init__(self, mode: int | cfg.Mode | cfg.ModeConfig = 0,
                 stereo: bool = True, with_rds: bool = False,
                 batch_shape: tuple[int, ...] = (),
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        pin_fp32_matmul()
        self.mc = (mode if isinstance(mode, cfg.ModeConfig)
                   else cfg.get_mode_config(mode))
        self.stereo = stereo
        self.with_rds = with_rds and self.mc.rds is not None
        self.coeffs = design_coeffs(self.mc, device=self.device)
        self.state = init_state(self.mc, batch_shape, device=self.device)

    def _as_input(self, x) -> torch.Tensor:
        """uint8 stays uint8 (normalized on the device), anything else
        becomes float32; the result is contiguous on this receiver's
        device."""
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = np.array(x)     # torch wraps only writable numpy memory
        t = torch.as_tensor(x)
        if t.dtype != torch.uint8:
            t = t.to(_F32)
        return t.to(self.device).contiguous()

    def process(self, iq_block) -> BlockOutputs:
        out, self.state = process_block(
            self._as_input(iq_block), self.coeffs, self.state, self.mc,
            stereo=self.stereo, with_rds=self.with_rds)
        return out

    def _run_blocks(self, iq: torch.Tensor, n_blocks: int,
                    block_size: int) -> BlockOutputs:
        # one copy into block-major layout, so every block is contiguous
        blocks = iq[..., : n_blocks * block_size].reshape(
            iq.shape[:-1] + (n_blocks, block_size)).movedim(-2, 0)
        outs, self.state = run_blocks(blocks.contiguous(), self.coeffs,
                                      self.state, self.mc, self.stereo,
                                      self.with_rds)
        return outs

    def run(self, iq, block_size: Optional[int] = None) -> BlockOutputs:
        """Stream a whole recording block by block; returns the per-block
        outputs stacked on a new leading block axis."""
        if block_size is None:
            block_size = self.mc.default_block_size(self.with_rds)
        iq = self._as_input(iq)
        n_blocks = iq.shape[-1] // block_size
        if n_blocks == 0:
            raise ValueError(f"capture of {iq.shape[-1]} samples is shorter "
                             f"than one block of {block_size}")
        return self._run_blocks(iq, n_blocks, block_size)

    def iter_run(self, iq, block_size: Optional[int] = None,
                 chunk_blocks: int = 64):
        """Stream a long recording in chunks of ``chunk_blocks`` blocks.

        Device and host memory stay O(chunk) however long the capture: each
        chunk is converted and copied to the device on its own, and its
        outputs come back as host numpy arrays (``BlockOutputs`` stacked
        (blocks, ..., out_len)).  The state carries across chunks, so the
        chunks concatenate bit-identically to one :meth:`run`."""
        if block_size is None:
            block_size = self.mc.default_block_size(self.with_rds)
        if isinstance(iq, torch.Tensor):
            iq = iq.detach().cpu().numpy()
        n_blocks = iq.shape[-1] // block_size
        for k0 in range(0, n_blocks, chunk_blocks):
            k1 = min(k0 + chunk_blocks, n_blocks)
            chunk = self._as_input(iq[..., k0 * block_size: k1 * block_size])
            outs = self._run_blocks(chunk, k1 - k0, block_size)
            yield map_state(lambda a: a.cpu().numpy(), outs)
