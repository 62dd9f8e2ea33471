"""The unified arena scan: the per-tile stages (`stages`), the plain
engines (`ref`), metadata packing (`ops`), and the CUDA kernel's wrapper
(`kernel`, source in ``csrc/arena_scan.cu``). The filtered_topk (G = 1) and
grouped_topk (G >= 1) families are thin configurations of it."""
from repro_torch.kernels.arena_scan.stages import (NEG_INF, ScanSpec,
                                                   merge_topk)

__all__ = ["NEG_INF", "ScanSpec", "merge_topk"]
