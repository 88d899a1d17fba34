"""Property test of the port's two-tier ``FrameStore``
(``repro_torch.core.memory``), the reference's
``tests/test_spill_properties.py`` run on the port's own twins, with its
``max_examples``: for random append / trim / get sequences every id at
or above the spill floor reads back bit for bit against an unbounded
single-tier twin, and every id below it raises ``IndexError``.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis package")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core.memory import FrameStore  # noqa: E402


@settings(max_examples=40, deadline=None)
@given(data=st.data(), spill=st.booleans())
def test_random_ops_match_unbounded_twin(data, spill):
    """Random append / trim / get: every id at or above the spill floor
    reads back bit for bit, every id below it raises ``IndexError``."""
    tmp = tempfile.mkdtemp() if spill else None
    try:
        fs = FrameStore(os.path.join(tmp, "s") if spill else None,
                        segment_frames=3, cache_segments=2)
        twin = FrameStore()
        counter = 0
        for _ in range(data.draw(st.integers(2, 12))):
            op = data.draw(st.sampled_from(["append", "trim", "get"]))
            if op == "append":
                k = data.draw(st.integers(1, 5))
                frames = (np.arange(counter, counter + k,
                                    dtype=np.float32)[:, None, None, None]
                          * np.ones((1, 2, 2, 3), np.float32))
                counter += k
                fs.append(frames)
                twin.append(frames)
            elif op == "trim" and len(fs):
                fs.trim(data.draw(st.integers(0, len(fs))))
            elif op == "get" and len(fs):
                i = data.draw(st.integers(0, len(fs) - 1))
                if i >= fs.spill_floor:
                    assert fs.get([i]).tobytes() == twin.get([i]).tobytes()
                else:
                    with pytest.raises(IndexError):
                        fs.get([i])
        assert fs.spill_floor == (0 if spill else fs.base)
        assert fs.io_stats["spilled_frames"] == (fs.trimmed if spill else 0)
        for i in range(len(fs)):
            if i >= fs.spill_floor:
                assert fs.get([i]).tobytes() == twin.get([i]).tobytes()
            else:
                with pytest.raises(IndexError):
                    fs.get([i])
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
