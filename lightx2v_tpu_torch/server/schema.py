"""Task schema (counterpart of ``lightx2v_tpu.server.schema``): the same
fields and defaults as the JAX package's pydantic models, as dataclasses
(the card machine has no ``pydantic``).

``from_dict`` takes a request body as pydantic v2 validates it in lax mode:
unknown keys are ignored, ``None`` is taken for the ``Optional`` fields
only, an int field takes a bool, an integral float (|x| < 2**63) or an
int-valued string (``" 5"``, ``"1_000"``, ``"5.00"``), a bool field takes 0 /
1 or one of pydantic's words (``"yes"``, ``"off"``, ...), and anything else
that does not fit its field raises ``ValueError`` (the API answers 422)."""

from __future__ import annotations

import dataclasses
import math
import re
import typing
from dataclasses import dataclass
from typing import Any, Dict, Optional

_INT_STR = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _as_int(v):
    if isinstance(v, int):  # bool included: True -> 1
        return int(v)
    if isinstance(v, float) and math.isfinite(v) and v.is_integer() and -2**63 < v < 2**63:
        return int(v)
    if isinstance(v, str) and _INT_STR.fullmatch(v.strip()):
        return int(v.strip().split(".")[0])
    raise ValueError("Input should be a valid integer")


def _as_bool(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _TRUE | _FALSE:
        return v.lower() in _TRUE
    raise ValueError("Input should be a valid boolean")


def _as_str(v):
    if isinstance(v, str):
        return v
    raise ValueError("Input should be a valid string")


def _as_dict(v):
    if isinstance(v, dict):
        return dict(v)
    raise ValueError("Input should be a valid dictionary")


_CHECK = {int: _as_int, bool: _as_bool, str: _as_str, dict: _as_dict}


class _Model:
    """``from_dict`` (pydantic's lax-mode decisions, above) and
    ``model_dump`` for the dataclasses below."""

    @classmethod
    def from_dict(cls, body: Dict[str, Any]):
        if not isinstance(body, dict):
            raise ValueError(f"{cls.__name__}: the body should be a JSON object")
        hints = typing.get_type_hints(cls)
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in body:
                if f.default is dataclasses.MISSING:
                    raise ValueError(f"{f.name}: Field required")
                continue
            tp, v = hints[f.name], body[f.name]
            optional = typing.get_origin(tp) is typing.Union
            if optional:
                tp = next(a for a in typing.get_args(tp) if a is not type(None))
            if v is None:
                if not optional:
                    raise ValueError(f"{f.name}: Input should not be None")
                kw[f.name] = None
                continue
            try:
                kw[f.name] = _CHECK[tp](v)
            except ValueError as e:
                raise ValueError(f"{f.name}: {e}") from None
        return cls(**kw)

    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class TaskRequest(_Model):
    task_id: Optional[str] = None
    prompt: str = ""
    use_prompt_enhancer: bool = False
    negative_prompt: str = ""
    image_path: str = ""
    audio_path: str = ""
    num_fragments: int = 1
    save_video_path: str = ""
    infer_steps: Optional[int] = None
    target_video_length: Optional[int] = None
    seed: int = 42
    video_duration: Optional[int] = None
    # per-task config overrides (the web UI's options panel: attention_type, mm_type, feature_caching,
    # tiny_vae, ...), merged into the runner config by the service worker
    options: Optional[dict] = None


@dataclass
class TaskResponse(_Model):
    task_id: str
    task_status: str
    save_video_path: str


@dataclass
class TaskStatusResponse(_Model):
    task_id: str
    status: str
    error: Optional[str] = None


@dataclass
class ServiceStatusResponse(_Model):
    service_status: str  # "idle" | "busy"
    task_id: Optional[str] = None


@dataclass
class StopTaskResponse(_Model):
    stop_status: str
    reason: Optional[str] = None
