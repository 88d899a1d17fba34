"""Serving: the continuous-batching engine and the Venus service."""

from repro_torch.serving.engine import (  # noqa: F401
    Request,
    ServingEngine,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.serving.venus_service import (  # noqa: F401
    StreamQuery,
    VenusService,
)
