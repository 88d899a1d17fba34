"""The port's cost model (``repro_torch.core.costmodel``) against the
reference's: every class and function, the paper's constants and
non-default ones, equal to the float."""

import pytest

from repro.core import costmodel as ref
from repro_torch.core import costmodel as port

LINKS = [{}, {"bandwidth_bps": 20e6, "rtt_s": 0.12}]
VLMS = [{}, {"tokens_per_frame": 64, "prefill_tok_per_s": 3000.0,
             "decode_tok_per_s": 25.0, "answer_tokens": 12}]
FMTS = [{}, {"height": 224, "width": 224, "bytes_per_frame_jpeg": 18_000}]


def _pair(cls, kw):
    return getattr(port, cls)(**kw), getattr(ref, cls)(**kw)


@pytest.mark.parametrize("i", range(2))
def test_models_match(i):
    link, rlink = _pair("LinkModel", LINKS[i])
    vlm, rvlm = _pair("CloudVLMModel", VLMS[i])
    fmt, rfmt = _pair("FrameFormat", FMTS[i])
    for n in (0, 1, 60_000, 7_654_321):
        assert link.transfer_s(n) == rlink.transfer_s(n)
    for n, t in ((0, 0), (1, 64), (32, 17)):
        assert vlm.infer_s(n, t) == rvlm.infer_s(n, t)
    assert fmt.raw_bytes() == rfmt.raw_bytes()


@pytest.mark.parametrize("i", range(2))
def test_latencies_match(i):
    kw = dict(link=_pair("LinkModel", LINKS[i]),
              vlm=_pair("CloudVLMModel", VLMS[i]),
              fmt=_pair("FrameFormat", FMTS[i]))

    def both(fn, **args):
        got = getattr(port, fn)(**args, **{k: v[0] for k, v in kw.items()})
        want = getattr(ref, fn)(**args, **{k: v[1] for k, v in kw.items()})
        assert got.parts == want.parts and got.total == want.total
        assert str(got) == str(want)

    edge = {"similarity": 0.0123, "sample_expand": 0.0042, "embed": 0.031}
    both("venus_query_latency", measured_edge_s=edge, n_frames_uploaded=9)
    both("cloud_only_latency", video_frames=2400, selected_frames=32,
         select_algo_s=1.7)
    both("edge_cloud_latency", edge_select_s=3.2, selected_frames=16)


def test_breakdown_adds_like_the_reference():
    got, want = port.LatencyBreakdown(), ref.LatencyBreakdown()
    for name, s in (("a", 0.1), ("b", 0.25), ("a", 0.05)):
        got.add(name, s)
        want.add(name, s)
    assert got.parts == want.parts and got.total == want.total
