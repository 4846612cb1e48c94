"""Continuous-batching serving engine — the supported ``repro_torch.serving`` API.

:class:`ServeSession` keeps ONE persistent decode batch alive: each of its
``n_slots`` cache rows independently carries a request at its own sequence
position, newly admitted requests are prefilled *exactly* (alone, no
cross-request padding) and spliced into free rows while every other row keeps
decoding, and finished rows free their cache blocks for the next admission —
no request ever waits for a batch to drain.  The measured phases are
hierarchical ``repro_torch.timing`` scopes (``serve`` enclosing ``serve/admit``,
``serve/prefill``, ``serve/decode``) and the bookkeeping events are lock-free
counters (``serve/queued|admitted|shed|tokens``), which is what puts serving
on the paper's measure→decide→act loop: a
:class:`~repro_torch.adapt.serving.ServingControl` registered on the session's
:class:`~repro_torch.adapt.controller.ControlLoop` reads those channels and steers
admission width (the steerable ``serving.max_active`` parameter), sheds load
against the :class:`~repro_torch.serving.slo.ServiceLevel`, and records every
decision as an ``ADAPT/serving::*`` row — serving adaptation shares the one
control plane with training (no private steering rule remains on this
path).

Admission is capacity-checked three ways before a request leaves the queue: a
free slot, the ``serving.max_active`` width, and a
:class:`~repro_torch.serving.kvcache.KVCacheManager` block reservation sized to the
request's worst case — so decode can never run out of cache mid-stream.

Correctness invariant (pinned by ``tests/test_torch_serving.py``): greedy
outputs are token-identical to running each request alone through
``prefill``/``decode_step``, across mid-stream admissions — per-request
prefill is exact, and the decode cache's per-row ``pos`` lets rows at
different positions share one lock-step decode.

PyTorch port: the model runs eagerly on ``device`` (``"cuda"`` unless the
caller passes ``"cpu"``).  PyTorch returns before the card finishes, so the
``serve/prefill`` and ``serve/decode`` scopes end with a device synchronise —
without it the timers would measure the launch and the serving controller
would steer on it.  Every family of the reference is served: dense, MoE,
hybrid, SSM, vlm and encdec.

vlm: the vision frontend is a stub, so each prefill runs behind a prefix of
``n_vision_patches`` zero patch embeddings (:func:`prefill_batch`, as the
reference's engine builds it); the prefix takes cache positions, which the
KV budget and ``validate_request`` count.

encdec: the audio frontend is a stub too, so each prefill encodes
``len(prompt)`` zero source frames (:func:`prefill_batch`, as the
reference's engine builds them).  RMSNorm of zeros is zero, so the encoder
output, the cross K/V and every cross-attention output are zero on this
path; the cache row holds the cross K/V and the source length, which the
splice copies with the rest of the row.

MoE: a decode step routes its whole slot batch as one routing group, free
slots included (they decode their last token on), so under the config's
capacity factor the slots compete for expert capacity and a slot's tokens can
depend on its neighbours.  Continuous batching is then token-identical to
serving each request alone only when no token drops.  These are the
reference's semantics (``tests/test_serve_consistency.py``), kept as they are.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..core.clocks import resolve_device_events
from ..core.params import ParamRegistry, param_registry
from ..core.timers import TimerDB, timer_db
from ..models import model as M
from ..models.config import ArchConfig
from ..models.layers import tree_leaves
from .batching import Slot, make_cache_splicer, slot_stats
from .kvcache import KVCacheManager
from .slo import ServiceLevel

__all__ = ["Request", "RequestHandle", "RequestResult", "ServeSession", "prefill_batch"]


@dataclass
class Request:
    """One generation request: prompt tokens in, up to ``max_new_tokens`` out.

    Pure work description — :class:`ServeSession` reports progress and
    completion through :class:`RequestResult`, never by mutating the request.
    """

    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_token: int | None = None


@dataclass
class RequestResult:
    """Per-request view of a finished (or shed) request.

    ``status`` is ``"completed"`` or ``"shed"``; timestamps are
    ``time.monotonic`` values (``admitted_at``/``first_token_at`` are ``None``
    for shed requests, which never reached a slot).  ``truncated`` counts
    prompt tokens dropped at ``submit`` to fit the cache.
    """

    rid: int
    tokens: list[int]
    status: str
    submitted_at: float
    finished_at: float
    admitted_at: float | None = None
    first_token_at: float | None = None
    prompt_len: int = 0
    truncated: int = 0

    @property
    def latency_s(self) -> float:
        """Submit-to-finish wall time."""
        return self.finished_at - self.submitted_at

    @property
    def queue_s(self) -> float | None:
        """Time spent waiting for admission (``None`` if never admitted)."""
        return None if self.admitted_at is None else self.admitted_at - self.submitted_at

    @property
    def ttft_s(self) -> float | None:
        """Submit-to-first-token wall time (``None`` if shed before one)."""
        return None if self.first_token_at is None else self.first_token_at - self.submitted_at

    def stats(self) -> dict[str, object]:
        """The per-request stats row (JSON-ready)."""
        return {
            "rid": self.rid,
            "status": self.status,
            "prompt_len": self.prompt_len,
            "n_tokens": len(self.tokens),
            "truncated": self.truncated,
            "latency_s": self.latency_s,
            "queue_s": self.queue_s,
            "ttft_s": self.ttft_s,
        }


class RequestHandle:
    """Future-like handle returned by :meth:`ServeSession.submit`.

    ``done`` is non-blocking; :meth:`result` cooperatively drives the engine
    (``step()`` in a loop) until this request finishes or is shed — the
    single-threaded analogue of awaiting a server response.
    """

    __slots__ = (
        "request", "_engine", "_result", "_submitted_at", "_admitted_at",
        "_first_token_at", "_tokens", "_truncated", "_slot",
    )

    def __init__(self, request: Request, engine: ServeSession) -> None:
        self.request = request
        self._engine = engine
        self._result: RequestResult | None = None
        self._submitted_at = 0.0
        self._admitted_at: float | None = None
        self._first_token_at: float | None = None
        self._tokens: list[int] = []
        self._truncated = 0
        self._slot = None

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return self._result is not None

    def result(self) -> RequestResult:
        while self._result is None:
            self._engine.step()
        return self._result


def validate_request(req: Request, max_seq: int, n_prefix: int = 0) -> int:
    """Admission validation shared by both engines: reject impossible
    requests, left-truncate (keep the newest tokens of) prompts that would
    overrun the cache.  Returns the number of prompt tokens dropped.

    A request needs ``prompt + max_new_tokens`` cache positions (plus the
    vision-patch prefix for vlm); writing past ``max_seq`` would be an
    out-of-bounds cache write mid-decode (a device-side fault on the card), so
    the bound is enforced here, at submit time.
    """
    if req.max_new_tokens < 1:
        raise ValueError(f"request {req.rid}: max_new_tokens must be >= 1")
    if not req.prompt:
        raise ValueError(f"request {req.rid}: empty prompt")
    budget = max_seq - req.max_new_tokens - n_prefix
    if budget < 1:
        raise ValueError(
            f"request {req.rid}: max_new_tokens={req.max_new_tokens} leaves no "
            f"prompt room within max_seq={max_seq} (prefix {n_prefix})"
        )
    drop = len(req.prompt) - budget
    if drop > 0:
        req.prompt = list(req.prompt[drop:])
    return max(drop, 0)


def prefill_batch(cfg: ArchConfig, prompt: list[int], device) -> dict[str, torch.Tensor]:
    """The batch of one request's prefill: its prompt and the stub
    frontends' zeros, bf16, as the reference's engine builds them: for vlm
    the patch embeddings (1, n_vision_patches, d_model), for encdec the
    source frames (1, len(prompt), d_model)."""
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32, device=device)}
    n_prefix = M.prefix_positions(cfg)
    if n_prefix:
        batch["patch_embeds"] = torch.zeros((1, n_prefix, cfg.d_model), dtype=torch.bfloat16,
                                            device=device)
    if cfg.family == "encdec":
        batch["src_frames"] = torch.zeros((1, len(prompt), cfg.d_model), dtype=torch.bfloat16,
                                          device=device)
    return batch


def _percentile(values: list[float], q: float) -> float:
    """``np.percentile`` with the degenerate cases pinned: empty -> 0.0,
    single sample -> that sample (no interpolation over a length-1 axis)."""
    if not values:
        return 0.0
    if len(values) == 1:
        return float(values[0])
    return float(np.percentile(values, q))


class ServeSession:
    """The continuous-batching engine over one model + one timing session.

    Parameters
    ----------
    cfg / params:
        Model configuration and weights (the families
        :mod:`repro_torch.models.model` serves: dense, MoE, hybrid, SSM, vlm,
        encdec),
        with every weight on ``device``.
    session:
        A :class:`repro_torch.timing.TimingSession` — the primary wiring.  Supplies
        the timer database *and* the control loop the serving controller
        registers on, so serving and training adaptation share one loop.
    n_slots:
        Rows of the persistent decode batch (compiled shape; admission width
        is steered *within* it via ``serving.max_active``).
    max_seq:
        Cache positions per slot (prompt + generated tokens + prefix).
    block_size:
        KV-cache accounting granularity (see
        :class:`~repro_torch.serving.kvcache.KVCacheManager`).
    slo:
        The :class:`~repro_torch.serving.slo.ServiceLevel` the controller enforces;
        ``None`` serves best-effort (no steering targets, no shedding).
    db / registry:
        Escape hatches: explicit timer database (defaults to ``session.db``,
        then the process default) and steerable-parameter registry.
    control:
        When true (default), build and register the
        :class:`~repro_torch.adapt.serving.ServingControl`; the engine polls its
        control loop once per :meth:`step`.
    device:
        Where the model runs and the caches live (default ``"cuda"``).
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        session=None,
        n_slots: int = 8,
        max_seq: int = 256,
        block_size: int = 16,
        slo: ServiceLevel | None = None,
        db: TimerDB | None = None,
        registry: ParamRegistry | None = None,
        control: bool = True,
        device: str | torch.device = "cuda",
    ) -> None:
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        off = {str(t.device) for t in tree_leaves(params) if t.device != self.device}
        if off:
            raise ValueError(f"params must lie on {self.device}, found {sorted(off)}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.slo = slo if slo is not None else ServiceLevel()
        if session is not None and db is None:
            db = session.db
        self._db = db if db is not None else timer_db()
        self._registry = registry if registry is not None else param_registry()
        self._registry.declare(
            "serving.max_active", n_slots, steerable=True,
            doc="admission width of the persistent decode batch "
                "(steered by ADAPT/serving from decode latency)",
            validator=lambda v: isinstance(v, int) and v >= 1,
        )
        self._n_prefix = M.prefix_positions(cfg)

        # phase scopes pre-resolved once; real paths, so `serve` parents them
        self._scope_serve = self._db.scope_handle("serve")
        self._scope_admit = self._db.scope_handle("serve/admit")
        self._scope_prefill = self._db.scope_handle("serve/prefill")
        self._scope_decode = self._db.scope_handle("serve/decode")
        from ..timing.scopes import counter

        self._c_queued = counter("serve/queued", db=self._db)
        self._c_admitted = counter("serve/admitted", db=self._db)
        self._c_shed = counter("serve/shed", db=self._db)
        self._c_tokens = counter("serve/tokens", db=self._db)

        self.kv = KVCacheManager(
            cfg, n_slots=n_slots, max_seq=max_seq, block_size=block_size, db=self._db
        )
        self._slots = [Slot(i) for i in range(n_slots)]
        self._queue: deque[RequestHandle] = deque()
        self.completed: list[RequestResult] = []
        self.shed_results: list[RequestResult] = []
        self._steps = 0
        self._tokens_emitted = 0

        self._cache = None  # allocated lazily on first admission
        self._next_tok = np.zeros(n_slots, np.int32)
        self._splice = make_cache_splicer(cfg, n_slots, max_seq)

        self._control = None
        self._loop = None
        if control:
            if session is not None:
                self._loop = session.control_loop
            else:
                from ..adapt.controller import ControlLoop

                self._loop = ControlLoop(self._db)
            from ..adapt.serving import ServingControl

            self._control = ServingControl(self, slo=self.slo, registry=self._registry)
            self._loop.register(self._control)

    # -- introspection ----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slots if not s.free)

    @property
    def max_active(self) -> int:
        """Effective admission width: the steerable parameter, capped at the
        compiled slot count."""
        return min(int(self._registry.get("serving.max_active")), self.n_slots)

    @property
    def control_loop(self):
        """The adapt loop serving decisions land on (``None`` with
        ``control=False``)."""
        return self._loop

    # -- submission -------------------------------------------------------------
    def submit(self, request: Request) -> RequestHandle:
        """Validate, enqueue, and return the request's future-like handle.

        Prompts that would overrun the cache are left-truncated (newest
        tokens kept) — the drop count lands on ``RequestResult.truncated``;
        impossible requests (empty prompt, ``max_new_tokens`` that cannot fit
        at all) raise ``ValueError`` here rather than corrupting the cache.
        """
        truncated = validate_request(request, self.max_seq, self._n_prefix)
        handle = RequestHandle(request, self)
        handle._submitted_at = time.monotonic()
        handle._truncated = truncated
        self._queue.append(handle)
        self._c_queued(1)
        return handle

    # -- actuators (driven by ADAPT/serving) -------------------------------------
    def shed(self, n: int) -> list[RequestResult]:
        """Drop ``n`` queued requests per the SLO's ``shed_from`` policy;
        their handles resolve immediately with ``status="shed"``."""
        dropped: list[RequestResult] = []
        now = time.monotonic()
        for _ in range(min(n, len(self._queue))):
            handle = (
                self._queue.popleft() if self.slo.shed_from == "oldest"
                else self._queue.pop()
            )
            result = RequestResult(
                rid=handle.rid, tokens=[], status="shed",
                submitted_at=handle._submitted_at, finished_at=now,
                prompt_len=len(handle.request.prompt),
                truncated=handle._truncated,
            )
            handle._result = result
            self.shed_results.append(result)
            dropped.append(result)
            self._c_shed(1)
        return dropped

    def completion_rate(self) -> float:
        """Recent requests-per-second, measured over busy (``serve``-scoped)
        seconds — the rate the SLO queue-delay estimate divides by."""
        busy = self._scope_serve.timer.seconds()
        if busy <= 0.0:
            return 0.0
        return len(self.completed) / busy

    # -- the engine iteration ----------------------------------------------------
    def step(self) -> list[RequestResult]:
        """One engine iteration: admit into free slots, one lock-step decode,
        harvest finished requests, poll the control loop.  Returns the
        requests that finished this step."""
        finished: list[RequestResult] = []
        if self._queue or self.active_slots:
            self._steps += 1
            with self._scope_serve:
                self._admit(finished)
                if self.active_slots:
                    self._decode_once(finished)
            if self._loop is not None:
                self._loop.poll(self._steps)
        return finished

    def run_until_idle(self, max_steps: int | None = None) -> list[RequestResult]:
        """Drive :meth:`step` until queue and slots are empty; returns every
        request completed during the drain (shed requests excluded)."""
        drained: list[RequestResult] = []
        while self._queue or self.active_slots:
            drained.extend(self.step())
            if max_steps is not None:
                max_steps -= 1
                if max_steps <= 0:
                    break
        return drained

    # -- internals ---------------------------------------------------------------
    def _admit(self, finished: list[RequestResult]) -> None:
        while True:
            with self._scope_admit:
                handle = self._pick_admission()
            if handle is None:
                return
            self._prefill_into_slot(handle, finished)

    def _pick_admission(self) -> RequestHandle | None:
        if not self._queue or self.active_slots >= self.max_active:
            return None
        slot = next((s for s in self._slots if s.free), None)
        if slot is None:
            return None
        head = self._queue[0]
        req = head.request
        total = self._n_prefix + len(req.prompt) + req.max_new_tokens
        if not self.kv.can_admit(total):
            return None
        self._queue.popleft()
        blocks = self.kv.allocate(req.rid, total)
        slot.bind(req, head, blocks)
        head._slot = slot
        self._c_admitted(1)
        return head

    def _sync(self) -> None:
        """Wait for the card, so a scope's window ends when its work does;
        then fold the timer windows' finished device-event pairs."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            resolve_device_events()

    def _prefill_into_slot(self, handle: RequestHandle, finished: list[RequestResult]) -> None:
        slot: Slot = handle._slot
        req = handle.request
        now = time.monotonic()
        handle._admitted_at = now
        with self._scope_prefill:
            fresh = M.init_cache(self.cfg, 1, self.max_seq, device=self.device)
            batch = prefill_batch(self.cfg, req.prompt, self.device)
            fresh, logits = M.prefill(self.cfg, self.params, batch, fresh)
            self._sync()
        tok = int(torch.argmax(logits[0, : self.cfg.vocab_size]))
        handle._tokens = [tok]
        handle._first_token_at = time.monotonic()
        slot.generated = 1
        self._tokens_emitted += 1
        self._c_tokens(1)
        if req.max_new_tokens == 1 or (req.eos_token is not None and tok == req.eos_token):
            self._finish(slot, finished)
            return
        if self._cache is None:
            self._cache = M.init_cache(self.cfg, self.n_slots, self.max_seq, device=self.device)
        self._cache = self._splice(self._cache, fresh, slot.index)
        self._next_tok[slot.index] = tok

    def _decode_once(self, finished: list[RequestResult]) -> None:
        with self._scope_decode:
            tokens = torch.tensor(self._next_tok[:, None], device=self.device)
            self._cache, logits = M.decode_step(self.cfg, self.params, self._cache, tokens)
            self._sync()
        toks = torch.argmax(logits[:, : self.cfg.vocab_size], dim=-1).cpu().numpy()
        emitted = 0
        for slot in self._slots:
            if slot.free:
                continue
            tok = int(toks[slot.index])
            slot.handle._tokens.append(tok)
            slot.generated += 1
            self._next_tok[slot.index] = tok
            emitted += 1
            req = slot.request
            if slot.generated >= req.max_new_tokens or (
                req.eos_token is not None and tok == req.eos_token
            ):
                self._finish(slot, finished)
        self._tokens_emitted += emitted
        if emitted:
            self._c_tokens(emitted)

    def _finish(self, slot: Slot, finished: list[RequestResult]) -> None:
        handle: RequestHandle = slot.handle
        req = slot.request
        result = RequestResult(
            rid=req.rid,
            tokens=list(handle._tokens),
            status="completed",
            submitted_at=handle._submitted_at,
            finished_at=time.monotonic(),
            admitted_at=handle._admitted_at,
            first_token_at=handle._first_token_at,
            prompt_len=len(req.prompt),
            truncated=handle._truncated,
        )
        handle._result = result
        self.kv.free(req.rid)
        slot.release()
        self.completed.append(result)
        finished.append(result)

    # -- read side ---------------------------------------------------------------
    def stats(self) -> dict[str, float]:
        """Engine-level view: throughput, latency distribution, occupancy,
        shedding, and the KV pool (per-request rows live on
        :meth:`request_stats` / :meth:`RequestResult.stats`)."""
        lat = [r.latency_s for r in self.completed]
        ttft = [r.ttft_s for r in self.completed if r.ttft_s is not None]
        busy = self._scope_serve.timer.seconds()
        occupancy = slot_stats(self._slots)
        return {
            "completed": float(len(self.completed)),
            "shed": float(len(self.shed_results)),
            "queue_depth": float(self.queue_depth),
            "active_slots": float(occupancy.active),
            "occupancy": occupancy.occupancy,
            "max_active": float(self.max_active),
            "steps": float(self._steps),
            "tokens": float(self._tokens_emitted),
            "throughput_tokens_per_s": self._tokens_emitted / busy if busy > 0 else 0.0,
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "p95_latency_s": _percentile(lat, 95),
            "p95_ttft_s": _percentile(ttft, 95),
            "kv_utilization": self.kv.utilization(),
            "kv_high_water_blocks": float(self.kv.high_water),
        }

    def request_stats(self) -> list[dict[str, object]]:
        """Per-request stats rows, completed then shed, submission order."""
        rows = [r.stats() for r in self.completed]
        rows.extend(r.stats() for r in self.shed_results)
        return rows
