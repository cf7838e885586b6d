"""Receiver models of the PyTorch port: the per-block DAG and its block
programs (CUDA graphs of the block, ``models.program``), the wideband
channelizer (``models.channelizer``), and the host-side RDS decode and
group layer (``models.rds_decode``, ``models.rds_groups``)."""

from sdr_tpu_torch.models import rds_decode  # noqa: F401
from sdr_tpu_torch.models.receiver import (  # noqa: F401
    BlockOutputs,
    Receiver,
    ReceiverCoeffs,
    ReceiverState,
    design_coeffs,
    init_state,
    make_block_fn,
    process_block,
    run_blocks,
    run_blocks_scan,
)
