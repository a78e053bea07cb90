"""Inference beyond the batch CLI: streaming-chunk and live (real-time) synthesis."""

from quickvc_tpu_torch.infer.realtime import RealtimeSession, RealtimeWaveSession  # noqa: F401
from quickvc_tpu_torch.infer.streaming import streaming_infer  # noqa: F401
