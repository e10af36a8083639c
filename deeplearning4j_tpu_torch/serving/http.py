"""JSON request/response codec for the serving HTTP routes.

Counterpart of ``deeplearning4j_tpu/serving/http.py``, whole. Kept
transport-free (functions of a session and a body, testable without a
server; the server itself comes with the UI tier, ROADMAP.md queue 1 item
13): this module turns a request body into a numpy batch, runs it through
an InferenceSession, and maps serving errors onto HTTP statuses:

    400  malformed JSON / wrong shape or dtype
    404  unknown model (or no serving session attached)
    429  queue full, or shed by admission control (the shed response
         carries a Retry-After header computed from the model's
         current service rate)
    504  request timed out before execution
    503  session shut down
    500  device/runtime error

Wire format (TF-Serving-style):

    POST /serving/v1/models/<name>:predict
    {"instances": [[...], ...]}             -> {"predictions": [[...], ...]}
    {"instances": [...], "version": 2, "timeout_ms": 100,
     "priority": "high"}                    # high | normal | batch
"""

from __future__ import annotations

import json

import numpy as np

from deeplearning4j_tpu_torch.serving.admission import ShedError
from deeplearning4j_tpu_torch.serving.batcher import (
    QueueFullError, ServingShutdown, ServingTimeout)
from deeplearning4j_tpu_torch.serving.registry import ModelNotFound

PREDICT_SUFFIX = ":predict"
DECODE_SUFFIX = ":decode"
REGISTER_SUFFIX = ":register"
UNREGISTER_SUFFIX = ":unregister"
MODELS_PATH = "/serving/v1/models"


class HttpError(Exception):
    def __init__(self, status, message, headers=None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = dict(headers or {})


def _parse_suffix_path(path: str, suffix: str):
    if not path.startswith(MODELS_PATH + "/") or \
            not path.endswith(suffix):
        return None
    name = path[len(MODELS_PATH) + 1:-len(suffix)]
    return name or None


def parse_predict_path(path: str):
    """'/serving/v1/models/<name>:predict' -> name, or None when the
    path is not a predict route."""
    return _parse_suffix_path(path, PREDICT_SUFFIX)


def parse_decode_path(path: str):
    """'/serving/v1/models/<name>:decode' -> name, or None."""
    return _parse_suffix_path(path, DECODE_SUFFIX)


def parse_register_path(path: str):
    """'/serving/v1/models/<name>:register' -> name, or None. The
    fleet-admin seam: rollouts push spec-built model versions through
    the worker's versioned registry."""
    return _parse_suffix_path(path, REGISTER_SUFFIX)


def parse_unregister_path(path: str):
    """'/serving/v1/models/<name>:unregister' -> name, or None."""
    return _parse_suffix_path(path, UNREGISTER_SUFFIX)


def handle_register(admin, name: str, body: bytes) -> bytes:
    """POST /serving/v1/models/<name>:register — register a model
    version from a JSON spec through ``admin`` (any object with
    ``register_spec(name, spec, version, warmup=)`` and
    ``unregister(name, version)``: a fleet rollout's admin):

        {"spec": {"kind": "linear", ...}, "version": 2,
         "warmup": true}
        -> {"model": ..., "version": 2, "warmed": true}
    """
    if admin is None:
        raise HttpError(404, "no fleet admin attached "
                             "(UIServer.serveFleetAdmin(admin))")
    try:
        payload = json.loads(body or b"")
    except (ValueError, UnicodeDecodeError) as e:
        raise HttpError(400, f"malformed JSON body: {e}") from None
    if not isinstance(payload, dict) or \
            not isinstance(payload.get("spec"), dict) or \
            "version" not in payload:
        raise HttpError(400, 'body must be {"spec": {...}, '
                             '"version": N}')
    try:
        entry = admin.register_spec(
            name, payload["spec"], int(payload["version"]),
            warmup=bool(payload.get("warmup", True)))
    except (ValueError, TypeError) as e:
        raise HttpError(400, str(e)) from None
    except Exception as e:
        raise HttpError(500, f"{type(e).__name__}: {e}") from None
    return json.dumps({"model": name, "version": entry.version,
                       "warmed": entry.warmed}).encode()


def handle_unregister(admin, name: str, body: bytes) -> bytes:
    """POST /serving/v1/models/<name>:unregister — retract one version
    (rollout rollback) or every version: {"version": 2} / {}."""
    if admin is None:
        raise HttpError(404, "no fleet admin attached "
                             "(UIServer.serveFleetAdmin(admin))")
    try:
        payload = json.loads(body or b"{}")
    except (ValueError, UnicodeDecodeError) as e:
        raise HttpError(400, f"malformed JSON body: {e}") from None
    version = payload.get("version") if isinstance(payload, dict) \
        else None
    try:
        admin.unregister(name, version)
    except ModelNotFound as e:
        raise HttpError(404, f"unknown model: {e}") from None
    except (ValueError, TypeError) as e:
        raise HttpError(400, str(e)) from None
    except Exception as e:
        raise HttpError(500, f"{type(e).__name__}: {e}") from None
    return json.dumps({"model": name, "unregistered": version}).encode()


def handle_decode(session, name: str, body: bytes,
                  timing=None) -> bytes:
    """POST /serving/v1/models/<name>:decode — continuous-batching
    autoregressive decode:

        {"prompt": [1, 2, 3], "max_new_tokens": 16,
         "eos_id": 0, "priority": "high"}       # eos/priority optional
        -> {"model": ..., "tokens": [...]}

    ``timing`` receives the request's ``ttft`` seconds for the
    Server-Timing header (decode rollouts judge latency on TTFT).
    """
    if session is None:
        raise HttpError(404, "no serving session attached "
                             "(UIServer.serveModels(session))")
    try:
        payload = json.loads(body or b"")
    except (ValueError, UnicodeDecodeError) as e:
        raise HttpError(400, f"malformed JSON body: {e}") from None
    if not isinstance(payload, dict) or "prompt" not in payload \
            or "max_new_tokens" not in payload:
        raise HttpError(400, 'body must be {"prompt": [...], '
                             '"max_new_tokens": N}')
    priority = payload.get("priority", "normal")
    if priority not in ("high", "normal", "batch", "train"):
        raise HttpError(400, f"priority must be high|normal|batch|"
                             f"train, got {priority!r}")
    timeout = payload.get("timeout_ms")
    try:
        timeout = float(timeout) / 1e3 if timeout is not None else None
        prompt = [int(t) for t in payload["prompt"]]
        max_new = int(payload["max_new_tokens"])
        eos_id = payload.get("eos_id")
        eos_id = int(eos_id) if eos_id is not None else None
    except (TypeError, ValueError) as e:
        raise HttpError(400, f"bad decode parameters: {e}") from None
    try:
        tokens = session.decode(name, prompt, max_new, eos_id=eos_id,
                                timeout=timeout, priority=priority,
                                timing=timing)
    except ModelNotFound as e:
        raise HttpError(404, f"unknown decoder: {e}") from None
    except ShedError as e:
        raise HttpError(
            429, str(e),
            headers={"Retry-After": f"{max(e.retry_after, 0.001):.3f}"},
        ) from None
    except (ServingTimeout, TimeoutError) as e:
        raise HttpError(504, f"timed out: {e}") from None
    except ServingShutdown as e:
        raise HttpError(503, str(e)) from None
    except QueueFullError as e:
        raise HttpError(429, str(e)) from None
    except ValueError as e:
        raise HttpError(400, str(e)) from None
    except Exception as e:
        from deeplearning4j_tpu_torch.serving.decode import (DecodeError,
                                                       DecodeShutdown)

        if isinstance(e, DecodeShutdown):
            raise HttpError(503, str(e)) from None
        if isinstance(e, DecodeError):   # limits: too long for the pool
            raise HttpError(400, str(e)) from None
        raise HttpError(500, f"{type(e).__name__}: {e}") from None
    return json.dumps({"model": name, "tokens": tokens}).encode()


def handle_models(session) -> bytes:
    """GET /serving/v1/models payload."""
    if session is None:
        raise HttpError(404, "no serving session attached "
                             "(UIServer.serveModels(session))")
    return json.dumps({"models": session.models()}).encode()


def handle_predict(session, name: str, body: bytes,
                   timing=None) -> bytes:
    """POST /serving/v1/models/<name>:predict. ``timing`` (a dict)
    receives the request's queue/execute seconds so the transport can
    answer with a Server-Timing header."""
    if session is None:
        raise HttpError(404, "no serving session attached "
                             "(UIServer.serveModels(session))")
    try:
        payload = json.loads(body or b"")
    except (ValueError, UnicodeDecodeError) as e:
        raise HttpError(400, f"malformed JSON body: {e}") from None
    if not isinstance(payload, dict) or "instances" not in payload:
        raise HttpError(400, 'body must be {"instances": [...]}')
    timeout = payload.get("timeout_ms")
    try:
        timeout = float(timeout) / 1e3 if timeout is not None else None
    except (TypeError, ValueError):
        raise HttpError(400, f"timeout_ms must be a number, "
                             f"got {timeout!r}") from None
    version = payload.get("version")
    priority = payload.get("priority", "normal")
    if priority not in ("high", "normal", "batch", "train"):
        raise HttpError(400, f"priority must be high|normal|batch|"
                             f"train, got {priority!r}")
    try:
        entry = session.registry.get(name, version)
        x = np.asarray(payload["instances"],
                       dtype=entry.servable.dtype)
        y = session.predict(name, x, timeout=timeout, version=version,
                            priority=priority, timing=timing)
    except ModelNotFound as e:
        raise HttpError(404, f"unknown model: {e}") from None
    except ShedError as e:
        # overload policy, not backpressure accident: tell the client
        # WHEN to come back (admission computed it from the model's
        # recent service rate)
        raise HttpError(
            429, str(e),
            headers={"Retry-After": f"{max(e.retry_after, 0.001):.3f}"},
        ) from None
    except QueueFullError as e:
        raise HttpError(429, str(e)) from None
    except (ServingTimeout, TimeoutError) as e:
        raise HttpError(504, f"timed out: {e}") from None
    except ServingShutdown as e:
        raise HttpError(503, str(e)) from None
    except ValueError as e:
        raise HttpError(400, str(e)) from None
    except Exception as e:
        raise HttpError(500, f"{type(e).__name__}: {e}") from None
    return json.dumps({"model": name, "version": entry.version,
                       "predictions": np.asarray(y).tolist()}).encode()


def error_body(exc: HttpError) -> bytes:
    return json.dumps({"error": exc.message, "status": exc.status}).encode()
