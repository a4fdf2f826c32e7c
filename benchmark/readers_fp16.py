"""Helpers of the readers that hold a half-precision cell against the
device's dense fp16 tensor-core peak (``peaks_fp16.json``), and the kernel
names of its fused attention and its convolutions."""
from __future__ import annotations

from pathlib import Path
from typing import Optional

from harness import load_json
from readers import device_ms_per_frame

HERE = Path(__file__).resolve().parent
# SDPA's flash kernels (flash_fwd / flash_bwd_*) and its memory-efficient ones (fmha_cutlass*)
ATTENTION = ("flash", "fmha", "efficient_attention")
# cuDNN's forward, data- and weight-gradient kernels
CONVOLUTION = ("conv", "Conv", "wgrad", "dgrad", "fprop")


def is_attention(name: str) -> bool:
    return any(f in name for f in ATTENTION)


def is_convolution(name: str) -> bool:
    return (any(f in name for f in CONVOLUTION) and not is_attention(name)
            and "at::native" not in name)


def share_of_fp16_peak(run, work: dict, seconds: Optional[float]) -> Optional[float]:
    """100 x the least time of ``work`` (its bytes at the peak bandwidth or
    its operations at the fp16 peak, the larger) over ``seconds``."""
    peak = load_json(HERE / "peaks_fp16.json")["devices"].get(run.device_kind)
    if peak is None or not seconds:
        return None
    bound = max(work["bytes"] / peak["bytes_per_s"], work["flops"] / peak["fp16_flops_per_s"])
    return 100.0 * bound / seconds


def attention_ms(run) -> Optional[float]:
    return device_ms_per_frame(run, is_attention)
