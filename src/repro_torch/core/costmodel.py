"""Edge/cloud latency & cost model (paper Fig. 2 / Table II / Fig. 12).

A Jetson or a 100 Mbps WAN is not measured here, so end-to-end response
latency is decomposed exactly as the paper does and each term is either
**measured** on this host (edge compute: scene seg, clustering, MEM embed,
retrieval) or **modeled analytically** with the paper's constants
(communication at 100 Mbps; cloud VLM inference from a per-frame token
cost). Benchmarks label which is which.

Paper constants: 100 Mbps edge↔cloud; videos at 8 FPS; VLM consumes ~196
visual tokens/frame (LLaVA-OV).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class LinkModel:
    bandwidth_bps: float = 100e6          # paper: 100 Mbps
    rtt_s: float = 0.05

    def transfer_s(self, n_bytes: float) -> float:
        return self.rtt_s + 8.0 * n_bytes / self.bandwidth_bps


@dataclass(frozen=True)
class CloudVLMModel:
    """Analytic VLM inference latency: prefill dominated by visual tokens."""
    tokens_per_frame: int = 196
    prefill_tok_per_s: float = 8000.0     # L40S-class 7B prefill
    decode_tok_per_s: float = 60.0
    answer_tokens: int = 48

    def infer_s(self, n_frames: int, text_tokens: int = 64) -> float:
        prefill = (n_frames * self.tokens_per_frame + text_tokens
                   ) / self.prefill_tok_per_s
        return prefill + self.answer_tokens / self.decode_tok_per_s


@dataclass(frozen=True)
class FrameFormat:
    height: int = 448
    width: int = 448
    bytes_per_frame_jpeg: int = 60_000    # ~60 KB at 448², the paper's
                                          # uploads are compressed frames

    def raw_bytes(self) -> int:
        return self.height * self.width * 3


@dataclass
class LatencyBreakdown:
    parts: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.parts[name] = self.parts.get(name, 0.0) + seconds

    @property
    def total(self) -> float:
        return sum(self.parts.values())

    def __str__(self) -> str:
        inner = ", ".join(f"{k}={v:.3f}s" for k, v in self.parts.items())
        return f"LatencyBreakdown(total={self.total:.3f}s; {inner})"


def venus_query_latency(*, measured_edge_s: Dict[str, float],
                        n_frames_uploaded: int,
                        link: LinkModel = LinkModel(),
                        vlm: CloudVLMModel = CloudVLMModel(),
                        fmt: FrameFormat = FrameFormat()
                        ) -> LatencyBreakdown:
    """Assemble a Venus-style response latency: measured edge terms +
    modeled upload + modeled cloud inference."""
    b = LatencyBreakdown()
    for k, v in measured_edge_s.items():
        b.add(f"edge/{k}", v)
    b.add("comm/upload", link.transfer_s(
        n_frames_uploaded * fmt.bytes_per_frame_jpeg))
    b.add("cloud/vlm", vlm.infer_s(n_frames_uploaded))
    return b


def cloud_only_latency(*, video_frames: int, selected_frames: int,
                       select_algo_s: float,
                       link: LinkModel = LinkModel(),
                       vlm: CloudVLMModel = CloudVLMModel(),
                       fmt: FrameFormat = FrameFormat()
                       ) -> LatencyBreakdown:
    """BOLT/AKS cloud-only: ship the whole clip, select + infer on cloud."""
    b = LatencyBreakdown()
    b.add("comm/upload_video", link.transfer_s(
        video_frames * fmt.bytes_per_frame_jpeg))
    b.add("cloud/select", select_algo_s)
    b.add("cloud/vlm", vlm.infer_s(selected_frames))
    return b


def edge_cloud_latency(*, edge_select_s: float, selected_frames: int,
                       link: LinkModel = LinkModel(),
                       vlm: CloudVLMModel = CloudVLMModel(),
                       fmt: FrameFormat = FrameFormat()
                       ) -> LatencyBreakdown:
    """BOLT/AKS edge-cloud: frame-wise selection on the edge (slow), then
    upload only selected frames."""
    b = LatencyBreakdown()
    b.add("edge/select", edge_select_s)
    b.add("comm/upload", link.transfer_s(
        selected_frames * fmt.bytes_per_frame_jpeg))
    b.add("cloud/vlm", vlm.infer_s(selected_frames))
    return b
