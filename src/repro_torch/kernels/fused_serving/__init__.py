"""Weighted attention for the fused block-encoder serving step
(``predictor.forward_cached_fused``): the flash-attention recurrence with
the binary kv mask generalized to a per-key multiplicity weight."""
from repro_torch.kernels.fused_serving.ops import weighted_attention  # noqa: F401
