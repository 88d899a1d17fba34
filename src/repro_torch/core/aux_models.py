"""Auxiliary model stubs (paper Eq. 2): OCR and detector text prompts.

The paper runs lightweight models (EasyOCR, YOLO) over each index frame
and formats their outputs into one template string, embedded jointly
with the frame by the MEM. Their vision backbones are out of scope; the
interface is real: an ``AuxModel`` maps a frame (and, for the synthetic
world, its ground-truth annotations) to template text, which the
embedder's text tower reads beside the frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Protocol, Sequence


class AuxModel(Protocol):
    name: str

    def describe(self, frame, annotations: Optional[Dict] = None) -> str: ...


@dataclass
class OCRStub:
    """The world's text annotation: what EasyOCR would read off the
    frame."""
    name: str = "ocr"

    def describe(self, frame, annotations=None) -> str:
        if annotations and annotations.get("text"):
            return f"text: {annotations['text']}"
        return ""


@dataclass
class DetectorStub:
    """The world's object labels: what YOLO would detect."""
    name: str = "yolo"

    def describe(self, frame, annotations=None) -> str:
        if annotations and annotations.get("objects"):
            return "objects: " + ", ".join(annotations["objects"])
        return ""


def build_aux_prompt(models: Sequence[AuxModel], frame,
                     annotations: Optional[Dict] = None) -> str:
    """Eq. 2: t_i = AuxModels(k_i), formatted into one template string."""
    parts = [m.describe(frame, annotations) for m in models]
    return " | ".join(p for p in parts if p)
