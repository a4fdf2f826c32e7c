"""Device ms per step of the fused attention's kernels (SDPA's flash or
memory-efficient forward and backward kernels, by name)."""
from readers_fp16 import attention_ms


def read(run):
    return attention_ms(run)
