"""Core of the paper's contribution: a memory-access simulation environment
for graph processing accelerators (Dann, Ritter, Froening 2021).

The environment follows the paper's central observation: off-chip memory
access dominates graph-accelerator performance, so on-chip data flow need not
be simulated cycle-accurately.  Accelerator models therefore generate their
off-chip *request traces* (type, address, volume, ordering) which are played
through a DRAM timing model (Ramulator's bank state machines, timed on the
CUDA card by a hand-written kernel, ``repro_torch/csrc/dram_timing.cu``).
"""
from repro_torch.core.dram import (
    AddressMapping,
    DRAMConfig,
    DRAM_CONFIGS,
    MAPPING_SCHEMES,
    PAGE_POLICIES,
    dram_config,
)
from repro_torch.core.trace import (
    Trace,
    seq_read,
    seq_write,
    random_read,
    random_write,
    coalesce,
    concat,
    round_robin,
    proportional_interleave,
    split_round_robin,
)
from repro_torch.core.engine import (
    TimingReport,
    TraceBatch,
    dispatch_stats,
    reset_dispatch_stats,
    select_engine,
    simulate_batch,
    simulate_dram,
    simulate_many,
    simulate_sequential,
)
from repro_torch.core.metrics import SimReport
from repro_torch.core.memory_layout import MemoryLayout

__all__ = [
    "AddressMapping",
    "DRAMConfig",
    "DRAM_CONFIGS",
    "MAPPING_SCHEMES",
    "PAGE_POLICIES",
    "dram_config",
    "Trace",
    "split_round_robin",
    "seq_read",
    "seq_write",
    "random_read",
    "random_write",
    "coalesce",
    "concat",
    "round_robin",
    "proportional_interleave",
    "simulate_dram",
    "simulate_batch",
    "simulate_many",
    "simulate_sequential",
    "select_engine",
    "dispatch_stats",
    "reset_dispatch_stats",
    "TimingReport",
    "TraceBatch",
    "SimReport",
    "MemoryLayout",
]
