"""Continuous-batching inference replica — the port of
``kubeflow_controller_tpu/workloads/serve.py``.

One replica owns a fixed number of batch **slots** over a slot-paged KV
cache (``models/generate.py``) and runs ONE decode loop:

- new requests join the running batch at token boundaries — admission is
  "allocate ceil(prompt/page) pages + prefill into them", O(pages needed),
  never a cache reshape;
- a finished sequence vacates its slot and frees its pages immediately,
  so the next queued request starts decoding on the very next step;
- prefill shapes are **bucketed** to a small fixed set; PyTorch runs
  eagerly, so nothing is compiled per bucket, but ``prefill_compiles``
  still counts the distinct buckets seen, so the engine's stats keep the
  reference's meaning;
- with ``prefix_cache`` on, finished sequences keep their full KV pages in
  a refcounted page trie and a known prefix is shared (copy-on-write for a
  mid-page divergence), so only the divergent tail is prefilled.

The engine (``ServeConfig`` .. ``ServeEngine``) is a copy of the
reference's, with plain ``threading`` locks.  An engine built under a
trace context (``$KCTPU_TRACE_CONTEXT``, or ``trace.context``) emits each
completed request's ``serve/request`` span, parented to the gateway's
``gw/route`` span when the request carries its id (``trace_parent``), with
``serve/queue_wait``, ``serve/prefill`` and ``serve/decode`` under it.
``LlamaBackend`` runs the port's model on ``device`` (default
``"cuda"``; raises without CUDA unless the caller passes ``"cpu"``).

``python -m kubeflow_controller_tpu_torch.workloads.serve`` is the
executed-pod entry: a JSON-lines TCP front end plus a SIGTERM handler
implementing stop-intake -> finish-in-flight -> exit 0, with the
reference's env contract (``KCTPU_SERVE_*``).
"""

from __future__ import annotations

import json
import os
import signal
import socketserver
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.generate import (
    copy_cache_rows,
    init_paged_cache,
    paged_decode_step,
    paged_extend,
    paged_prefill,
)
from ..models.llama import LlamaConfig, llama_init
from ..obs import trace
from ..obs.phases import PHASE_DRAIN, PHASE_LOAD, PHASE_SERVING
from .compile_cache import build_kernels
from .progress import reporter

# Env contract for the executed entrypoint (planner/materialize.py wires
# the spec side; the kubelet injects the progress transport).
ENV_SERVE_PORT = "KCTPU_SERVE_PORT"
ENV_SERVE_SLOTS = "KCTPU_SERVE_SLOTS"
ENV_SERVE_MAX_LEN = "KCTPU_SERVE_MAX_LEN"
ENV_SERVE_PREFIX_CACHE = "KCTPU_SERVE_PREFIX_CACHE"

DEFAULT_SERVE_PORT = 8500


@dataclass
class ServeConfig:
    """Engine shape.  ``prefill_buckets`` is the closed set of prefill
    shapes: every prompt is padded up to the smallest bucket that holds
    it (on the reference this is the compile-cache contract; here it
    bounds the set of shapes the kernels see)."""

    slots: int = 8
    page_size: int = 16
    max_len: int = 256            # prompt + output ceiling per request
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128)
    # False = static batching baseline: admission only at batch
    # boundaries (all current sequences finished), finished sequences pad
    # until the whole batch completes.
    cont_batch: bool = True
    # Rolling window for qps/TTFT/ITL stats.
    stats_window_s: float = 5.0
    # Cross-request prefix page sharing: finished sequences retain their
    # full KV pages in a page-granular trie; admission of a known prefix
    # refcount-shares the resident pages and prefills only the divergent
    # tail (copy-on-write for a mid-page divergence).  Off by default —
    # retention changes the free-page accounting the static baselines
    # assert on.
    prefix_cache: bool = False
    # Intake bound: submit() refuses (overloaded) once the unadmitted
    # queue reaches this depth.  0 = unbounded.
    max_queue: int = 0

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest configured bucket holding ``prompt_len`` (the largest
        bucket for oversized prompts — they are truncated to it)."""
        for b in sorted(self.prefill_buckets):
            if prompt_len <= b:
                return b
        return max(self.prefill_buckets)

    def pages_per_slot(self) -> int:
        return -(-self.max_len // self.page_size)


class SubmitResult:
    """Typed intake verdict.  Truthiness == accepted, so existing
    ``if engine.submit(req)`` call sites keep working; refusals carry a
    ``reason`` the gateway uses to pick a recovery: ``draining`` means
    "retry another replica NOW", ``overloaded`` means "back off"."""

    __slots__ = ("accepted", "reason")

    def __init__(self, accepted: bool, reason: str = ""):
        self.accepted = accepted
        self.reason = reason

    def __bool__(self) -> bool:
        return self.accepted

    def __repr__(self) -> str:
        return (f"SubmitResult(accepted={self.accepted}"
                + (f", reason={self.reason!r})" if self.reason else ")"))


SUBMIT_OK = SubmitResult(True)
REFUSED_DRAINING = SubmitResult(False, "draining")
REFUSED_OVERLOADED = SubmitResult(False, "overloaded")


@dataclass
class Request:
    """One generation request.  ``tokens`` is the prompt; the engine
    appends generated ids to ``output``.  ``done`` fires when the request
    completes (or is rejected: ``error`` set)."""

    id: str
    tokens: List[int]
    max_new_tokens: int
    session: str = ""             # affinity key (gateway re-homes on drain)
    tier: str = "standard"        # admission tier (gateway sheds low first)
    trace_parent: str = ""        # gw/route span id -> serve/request parent
    submit_t: float = 0.0
    admit_t: float = 0.0          # queue wait = admit_t - submit_t
    first_token_t: float = 0.0    # TTFT = first_token_t - submit_t
    finish_t: float = 0.0
    output: List[int] = field(default_factory=list)
    error: str = ""
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def ttft_s(self) -> float:
        return max(0.0, self.first_token_t - self.submit_t)

    @property
    def latency_s(self) -> float:
        return max(0.0, self.finish_t - self.submit_t)


@dataclass
class ServeStats:
    """One stats snapshot — the beat payload shape."""

    step: int = 0                  # decode-loop steps executed
    completed: int = 0
    dropped: int = 0
    tokens_out: int = 0
    qps: float = 0.0
    tokens_per_sec: float = 0.0
    ttft_ms: float = 0.0           # p50 over the window
    ttft_p99_ms: float = 0.0
    itl_ms: float = 0.0
    queue_depth: int = 0
    slots_used: int = 0
    slots_total: int = 0
    phase: str = PHASE_LOAD
    prefill_compiles: int = 0
    # Prefix-cache effectiveness (all zero when prefix_cache is off).
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_reused_tokens: int = 0
    cow_copies: int = 0
    prefix_pages: int = 0          # pages resident in the trie

    @property
    def occupancy(self) -> float:
        return self.slots_used / self.slots_total if self.slots_total else 0.0

    @property
    def prefix_hit_ratio(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0

    def as_beat(self) -> Dict:
        """The serving dict ProgressReporter.beat(serving=...) publishes
        (PodProgress field names, snake_case)."""
        return {
            "qps": round(self.qps, 3),
            "ttft_ms": round(self.ttft_ms, 3),
            "ttft_p99_ms": round(self.ttft_p99_ms, 3),
            "itl_ms": round(self.itl_ms, 3),
            "queue_depth": self.queue_depth,
            "slots_used": self.slots_used,
            "slots_total": self.slots_total,
            "prefix_hit_ratio": round(self.prefix_hit_ratio, 4),
        }


def _pct(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


# ---------------------------------------------------------------------------
# Model backends
# ---------------------------------------------------------------------------

class LlamaBackend:
    """The real model: tiny-to-Mixtral Llama over the slot-paged KV cache,
    on ``device``.

    Holds the parameter modules and the physical page pool; ``prefill``,
    ``extend`` and ``decode`` update the pool in place.  ``params`` (a
    ``models.llama.Llama``, e.g. bridged from the JAX pytree by
    ``bridge.llama_from_jax``) replaces the seeded random init; it is moved
    to ``device`` at ``load``."""

    def __init__(self, cfg=None, seed: int = 0, device: DeviceLike = "cuda",
                 params=None):
        self.cfg = cfg or LlamaConfig.tiny()
        self.seed = seed
        self.device = resolve_device(device)
        self.prefill_compiles = 0   # distinct prefill buckets seen
        self.extend_compiles = 0    # distinct tail-extend buckets seen
        self._buckets: set = set()
        self._params = params
        self._model = None
        self._cache = None
        self._serve_cfg: Optional[ServeConfig] = None

    @property
    def model(self):
        return self._model

    def load(self, serve_cfg: ServeConfig) -> None:
        self._serve_cfg = serve_cfg
        if self._params is not None:
            self._model = self._params.to(self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self._model = llama_init(self.cfg, gen, self.device)
        num_pages = 1 + serve_cfg.slots * serve_cfg.pages_per_slot()
        self._cache = init_paged_cache(self.cfg, num_pages,
                                       serve_cfg.page_size, self.device)
        self._num_pages = num_pages

    def _ids(self, a) -> torch.Tensor:
        """Host int array -> int64 index tensor on the device."""
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def _seen(self, kind: str, bucket: int) -> None:
        if (kind, bucket) not in self._buckets:
            self._buckets.add((kind, bucket))
            if kind == "prefill":
                self.prefill_compiles += 1
            else:
                self.extend_compiles += 1

    def prefill(self, tokens_padded, rows, plen: int) -> int:
        """-> first sampled token (greedy)."""
        self._seen("prefill", tokens_padded.shape[1])
        logits, self._cache = paged_prefill(
            self._model, self._ids(tokens_padded), self._cache,
            self._ids(rows), int(plen), self.cfg)
        return int(torch.argmax(logits))

    def decode(self, tokens, positions, page_tables) -> List[int]:
        """One step over the full slot batch -> next token per slot."""
        logits, self._cache = paged_decode_step(
            self._model, self._ids(tokens), self._cache,
            self._ids(positions), self._ids(page_tables), self.cfg,
            self._serve_cfg.page_size)
        return torch.argmax(logits, dim=-1).tolist()

    def extend(self, tokens_padded, write_rows, read_rows,
               start_pos: int, plen: int) -> int:
        """Prefill a prompt's divergent TAIL over shared prefix pages ->
        first sampled token.  ``write_rows`` places the tail, ``read_rows``
        gathers the slot's FULL logical page span (prefix + tail)."""
        self._seen("extend", tokens_padded.shape[1])
        logits, self._cache = paged_extend(
            self._model, self._ids(tokens_padded), self._cache,
            self._ids(write_rows), self._ids(read_rows), int(start_pos),
            int(plen), self.cfg)
        return int(torch.argmax(logits))

    def copy_page(self, src_page: int, dst_page: int) -> None:
        """Copy-on-write: duplicate one physical page before the new
        sequence overwrites its divergent suffix rows."""
        ps = self._serve_cfg.page_size
        src = self._ids(src_page * ps + np.arange(ps))
        dst = self._ids(dst_page * ps + np.arange(ps))
        self._cache = copy_cache_rows(self._cache, src, dst)


class SyntheticBackend:
    """Deterministic no-model backend for unit tests and control-plane
    benches: the next token is a pure function of (last token, position),
    with an optional per-step delay standing in for device time."""

    def __init__(self, step_s: float = 0.0, vocab: int = 256):
        self.step_s = step_s
        self.vocab = vocab
        self.prefill_compiles = 0
        self.extend_compiles = 0
        self._buckets: set = set()

    def load(self, serve_cfg: ServeConfig) -> None:
        self._serve_cfg = serve_cfg

    def prefill(self, tokens_padded, rows, plen: int) -> int:
        bucket = tokens_padded.shape[1]
        if bucket not in self._buckets:
            self._buckets.add(bucket)
            self.prefill_compiles += 1
        if self.step_s:
            time.sleep(self.step_s)
        return (int(tokens_padded[0][plen - 1]) + plen) % self.vocab

    def extend(self, tokens_padded, write_rows, read_rows,
               start_pos: int, plen: int) -> int:
        # Matches prefill's pure function of (last token, total length):
        # a shared-prefix admission is token-identical to a cold one.
        key = ("extend", tokens_padded.shape[1])
        if key not in self._buckets:
            self._buckets.add(key)
            self.extend_compiles += 1
        if self.step_s:
            time.sleep(self.step_s)
        return ((int(tokens_padded[0][plen - 1]) + int(start_pos) + plen)
                % self.vocab)

    def copy_page(self, src_page: int, dst_page: int) -> None:
        pass  # no physical cache to copy

    def decode(self, tokens, positions, page_tables) -> List[int]:
        if self.step_s:
            time.sleep(self.step_s)
        return [(int(t) + int(p)) % self.vocab
                for t, p in zip(tokens, positions)]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class _Slot:
    __slots__ = ("req", "position", "pages", "last_token", "last_token_t",
                 "prompt_tokens")

    def __init__(self, req: Request, pages: List[int], position: int,
                 last_token: int):
        self.req = req
        self.pages = pages            # physical pages, logical-block order
        self.position = position      # absolute position of last_token
        self.last_token = last_token
        self.last_token_t = time.monotonic()
        # Tokens actually resident in the cache (prefix-cache retention
        # needs the page content keys; None when prefix_cache is off).
        self.prompt_tokens: Optional[List[int]] = None


class _PrefixNode:
    """One retained KV page in the prefix trie, keyed by the page's token
    content under its parent.  ``page`` holds one trie ref in the engine's
    refcount map for as long as the node lives."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int, last_used: int,
                 parent: Optional["_PrefixNode"] = None):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.parent = parent
        self.last_used = last_used


class ServeEngine:
    """Request queue + slot/page bookkeeping + the decode loop thread.

    Thread-safety: ``submit``/``drain``/``stats`` may be called from any
    thread; the decode loop is the only writer of slot state.  The intake
    lock guards only queues and counters — never held across a model
    call."""

    def __init__(self, backend, config: Optional[ServeConfig] = None,
                 on_ready: Optional[Callable[[], None]] = None):
        self.backend = backend
        self.config = config or ServeConfig()
        self.on_ready = on_ready
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: deque = deque()        # admitted-pending requests
        self._slots: List[Optional[_Slot]] = [None] * self.config.slots
        # Physical free-page list; page 0 is the shared scratch page.
        total_pages = 1 + self.config.slots * self.config.pages_per_slot()
        self._free_pages: List[int] = list(range(1, total_pages))
        # page -> refcount for every NON-free page: one ref per slot whose
        # table maps it + one ref while the prefix trie retains it.  A
        # page returns to _free_pages only at refcount zero, so eviction
        # can never free a page another slot still reads through.
        self._page_refs: Dict[int, int] = {}
        # Prefix trie roots (first-page keys).  Decode thread only.
        self._prefix_children: Dict[Tuple[int, ...], _PrefixNode] = {}
        self._prefix_nodes = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_reused_tokens = 0
        self._cow_copies = 0
        self._prefix_evictions = 0
        self._draining = False
        self._stopped = False
        self._ready = threading.Event()
        self._drained = threading.Event()
        # Static-batch baseline bookkeeping: admission is open from a batch
        # boundary (all slots empty) until the first decode step runs.
        self._batch_open = True
        self._start_t = time.monotonic()
        self._steps = 0
        self._completed = 0
        self._dropped = 0
        self._tokens_out = 0
        # (finish_t, ttft_s, latency_s, n_tokens) per completed request.
        self._window: deque = deque()
        self._itl: deque = deque(maxlen=2048)
        self._thread: Optional[threading.Thread] = None
        # Causal trace: under a job's trace context every completed request
        # emits its queue -> prefill -> decode span chain.
        self._trace_ctx = trace.TRACER.current_context()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="serve-engine",
                                        daemon=True)
        self._thread.start()

    def wait_ready(self, timeout: float = 60.0) -> bool:
        return self._ready.wait(timeout)

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    @property
    def drained(self) -> bool:
        return self._drained.is_set()

    def submit(self, req: Request) -> SubmitResult:
        """Enqueue a request.  The result is falsy when intake is closed —
        ``REFUSED_DRAINING`` (this replica is going away: retry another
        one now) or ``REFUSED_OVERLOADED`` (queue at ``max_queue``: back
        off).  The request is untouched on refusal so the caller can
        re-route it."""
        req.submit_t = req.submit_t or time.monotonic()
        if len(req.tokens) > self.config.max_len - 1:
            req.tokens = req.tokens[: self.config.max_len - 1]
        with self._lock:
            if self._draining or self._stopped:
                return REFUSED_DRAINING
            if 0 < self.config.max_queue <= len(self._queue):
                return REFUSED_OVERLOADED
            self._queue.append(req)
            self._wake.notify()
        return SUBMIT_OK

    def drain(self) -> List[Request]:
        """Stop intake; return the not-yet-admitted queue (for the caller
        to re-route).  In-flight sequences finish; ``drained`` fires once
        the last slot empties."""
        with self._lock:
            self._draining = True
            pending = list(self._queue)
            self._queue.clear()
            self._wake.notify()
        for req in pending:
            req.error = "rerouted"
            req.done.set()
        return pending

    def stop(self) -> None:
        """Hard stop: abandon everything (tests/teardown only — in-flight
        requests are counted dropped)."""
        with self._lock:
            self._stopped = True
            self._draining = True
            aborted = list(self._queue)
            self._queue.clear()
            aborted += [s.req for s in self._slots if s is not None]
            self._dropped += len(aborted)
            self._wake.notify()
        for req in aborted:
            if not req.done.is_set():
                req.error = "stopped"
                req.done.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    # -- stats --------------------------------------------------------------

    def stats(self) -> ServeStats:
        now = time.monotonic()
        with self._lock:
            cutoff = now - self.config.stats_window_s
            while self._window and self._window[0][0] < cutoff:
                self._window.popleft()
            window = list(self._window)
            itl = sorted(self._itl)
            used = sum(1 for s in self._slots if s is not None)
            depth = len(self._queue)
            # Early in the replica's life the window hasn't filled yet:
            # rate over the elapsed span, not the configured window.
            span = max(0.25, min(self.config.stats_window_s,
                                 now - self._start_t))
            phase = (PHASE_DRAIN if self._draining
                     else PHASE_SERVING if self._ready.is_set()
                     else PHASE_LOAD)
            st = ServeStats(
                step=self._steps,
                completed=self._completed,
                dropped=self._dropped,
                tokens_out=self._tokens_out,
                qps=round(len(window) / span, 3),
                tokens_per_sec=round(
                    sum(w[3] for w in window) / span, 3),
                ttft_ms=round(
                    _pct(sorted(w[1] for w in window), 0.5) * 1e3, 3),
                ttft_p99_ms=round(
                    _pct(sorted(w[1] for w in window), 0.99) * 1e3, 3),
                itl_ms=round(_pct(itl, 0.5) * 1e3, 3),
                queue_depth=depth,
                slots_used=used,
                slots_total=self.config.slots,
                phase=phase,
                prefill_compiles=getattr(self.backend,
                                         "prefill_compiles", 0),
                prefix_hits=self._prefix_hits,
                prefix_misses=self._prefix_misses,
                prefix_reused_tokens=self._prefix_reused_tokens,
                cow_copies=self._cow_copies,
                prefix_pages=self._prefix_nodes,
            )
        return st

    # -- decode loop --------------------------------------------------------

    def _run(self) -> None:
        self.backend.load(self.config)
        # First-decode-step readiness probe: one warmup request through
        # prefill + a decode step would need a real prompt; instead the
        # engine is "ready" the moment the backend finished loading AND the
        # first real decode step has run — but an idle replica must also
        # become ready, so readiness = model loaded + decode program built
        # via a scratch warmup sequence.
        self._warmup()
        self._ready.set()
        if self.on_ready is not None:
            try:
                self.on_ready()
            except Exception:  # noqa: BLE001 - readiness hook is advisory
                pass
        while True:
            with self._lock:
                if self._stopped:
                    break
                have_work = (any(s is not None for s in self._slots)
                             or bool(self._queue))
                if not have_work:
                    if self._draining:
                        break
                    self._wake.wait(timeout=0.05)
                    continue
            self._admit()
            self._step()
        self._drained.set()

    def _warmup(self) -> None:
        """Run one prefill (smallest bucket) and one decode step on a
        scratch sequence before declaring ready, so the first real
        request pays no first-call set-up (kernel build, allocator
        growth): readiness == model loaded + first decode step executed,
        the serving-readiness contract the controller keys on."""
        cfg = self.config
        bucket = min(cfg.prefill_buckets)
        pages = [self._free_pages.pop()]
        rows = np.zeros(bucket, np.int32)
        rows[0] = pages[0] * cfg.page_size
        tok = self.backend.prefill(
            np.zeros((1, bucket), np.int32), rows, 1)
        tokens = np.zeros(cfg.slots, np.int32)
        tokens[0] = tok
        positions = np.zeros(cfg.slots, np.int32)
        positions[0] = 1
        tables = np.zeros((cfg.slots, cfg.pages_per_slot()), np.int32)
        tables[0, 0] = pages[0]
        self.backend.decode(tokens, positions, tables)
        self._steps += 1
        self._free_pages.append(pages[0])

    # -- page refcounting (lock held) ---------------------------------------

    def _alloc_pages_locked(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages at refcount 1, evicting trie-only pages if the
        free list runs short; None when even eviction can't cover it."""
        if len(self._free_pages) < n and self.config.prefix_cache:
            self._evict_prefix_locked(n - len(self._free_pages))
        if len(self._free_pages) < n:
            return None
        pages = [self._free_pages.pop() for _ in range(n)]
        for p in pages:
            self._page_refs[p] = 1
        return pages

    def _unref_page_locked(self, page: int) -> None:
        r = self._page_refs.get(page, 1) - 1
        if r <= 0:
            self._page_refs.pop(page, None)
            self._free_pages.append(page)
        else:
            self._page_refs[page] = r

    def _evict_prefix_locked(self, shortfall: int) -> int:
        """Free up to ``shortfall`` trie-retained pages, oldest leaves
        first.  Only refcount-1 (trie-only) leaves are candidates — a
        page a live slot still maps is pinned by its extra ref, so this
        can never free memory out from under a running sequence.  Evicting
        a leaf may expose its parent as the next round's candidate."""
        freed = 0
        while freed < shortfall:
            leaves: List[_PrefixNode] = []
            stack = list(self._prefix_children.values())
            while stack:
                nd = stack.pop()
                if nd.children:
                    stack.extend(nd.children.values())
                elif self._page_refs.get(nd.page, 0) == 1:
                    leaves.append(nd)
            if not leaves:
                break
            leaves.sort(key=lambda nd: nd.last_used)
            progressed = False
            for nd in leaves:
                if freed >= shortfall:
                    break
                owner = (nd.parent.children if nd.parent is not None
                         else self._prefix_children)
                owner.pop(nd.key, None)
                self._prefix_nodes -= 1
                self._prefix_evictions += 1
                self._unref_page_locked(nd.page)
                freed += 1
                progressed = True
            if not progressed:
                break
        return freed

    def _release_slot_pages_locked(self, slot: _Slot) -> None:
        """Return a finished slot's pages: with prefix_cache on, full
        pages are RETAINED into the trie (the slot's ref transfers to the
        trie node, deduped against pages already there); everything else
        drops its ref."""
        cfg = self.config
        if not cfg.prefix_cache or slot.prompt_tokens is None:
            for p in slot.pages:
                self._unref_page_locked(p)
            return
        ps = cfg.page_size
        seq = list(slot.prompt_tokens) + list(slot.req.output)
        written = min(slot.position, len(seq))  # rows actually in cache
        full = min(written // ps, len(slot.pages))
        children = self._prefix_children
        parent: Optional[_PrefixNode] = None
        for i in range(full):
            key = tuple(seq[i * ps:(i + 1) * ps])
            node = children.get(key)
            if node is None:
                node = _PrefixNode(key, slot.pages[i], self._steps, parent)
                children[key] = node
                self._prefix_nodes += 1
                # slot ref transfers to the trie: no unref
            else:
                node.last_used = self._steps
                self._unref_page_locked(slot.pages[i])
            parent, children = node, node.children
        for p in slot.pages[full:]:
            self._unref_page_locked(p)

    def _admit(self) -> None:
        """Move queued requests into free slots (continuous mode: any
        step; static mode: only when the batch is empty — then fill it)."""
        cfg = self.config
        while True:
            with self._lock:
                free = [i for i, s in enumerate(self._slots) if s is None]
                if not self._queue or not free:
                    return
                if not cfg.cont_batch and not self._batch_open:
                    return  # static: admission closed until the batch ends
                req = self._queue.popleft()
            if not self._admit_one(req):
                return

    def _admit_one(self, req: Request) -> bool:
        """Admit one request: trie-match its prefix (prefix_cache only),
        allocate pages for the divergent tail, prefill/extend.  False =
        out of pages — the request went back to the queue head."""
        cfg = self.config
        ps = cfg.page_size
        t = req.tokens
        # Trie walk over full-page keys.  Cap the match at plen-1: the
        # final prompt token is never shared, so prefill always has >= 1
        # tail token to produce the first-token logits from.
        m = 0            # page-aligned shared prefix length
        k = 0            # extra tokens matched inside the next page (CoW)
        shared: List[_PrefixNode] = []
        cow_src: Optional[_PrefixNode] = None
        if cfg.prefix_cache:
            matchable = max(0, len(t) - 1)
            children = self._prefix_children
            while m + ps <= matchable:
                node = children.get(tuple(t[m:m + ps]))
                if node is None:
                    break
                shared.append(node)
                m += ps
                children = node.children
            limit = min(ps, matchable - m)
            for key, child in children.items():
                c = 0
                while c < limit and key[c] == t[m + c]:
                    c += 1
                if c > k:
                    k, cow_src = c, child
        # Oversized tails truncate to the largest bucket (the compiled
        # shape set is closed; max_len bounds output room).
        bucket = cfg.bucket_for(len(t) - m - k if len(t) > m + k else 1)
        tail = max(1, min(len(t) - m - k, bucket))
        eff = m + k + tail           # effective prompt length in cache
        first_block = m // ps
        need = (eff - 1) // ps - first_block + 1
        with self._lock:
            # Pin matched pages BEFORE allocating: the allocator may evict
            # refcount-1 trie leaves, which the matched nodes could be.
            pinned = [nd.page for nd in shared]
            if cow_src is not None:
                pinned.append(cow_src.page)
            for p in pinned:
                self._page_refs[p] += 1
            for nd in shared:
                nd.last_used = self._steps
            pages_new = self._alloc_pages_locked(need)
            if pages_new is None:
                # Admission is O(free pages): not enough — requeue at
                # the head and retry after evictions free pages.
                for p in pinned:
                    self._unref_page_locked(p)
                self._queue.appendleft(req)
                return False
        req.admit_t = time.monotonic()
        if k > 0:
            # Mid-page divergence: copy the whole matched page, then the
            # extend overwrites rows >= k with the divergent tail.
            self.backend.copy_page(cow_src.page, pages_new[0])
            cow_src.last_used = self._steps
            with self._lock:
                self._cow_copies += 1
                self._unref_page_locked(cow_src.page)  # copy pin released
        pages = [nd.page for nd in shared] + pages_new
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :tail] = np.asarray(t[m + k:eff], np.int32)
        write_rows = np.zeros(bucket, np.int32)
        for j in range(tail):
            pos = m + k + j
            write_rows[j] = pages[pos // ps] * ps + pos % ps
            # padding rows stay 0 — the scratch page
        if m + k == 0:
            first = self.backend.prefill(toks, write_rows, tail)
        else:
            # Gather through the slot's FULL logical span: shared prefix
            # pages + the fresh tail pages (unmapped blocks read scratch
            # row 0, masked out by the causal mask).
            read_rows = np.zeros(cfg.pages_per_slot() * ps, np.int32)
            for b, pg in enumerate(pages):
                read_rows[b * ps:(b + 1) * ps] = pg * ps + np.arange(ps)
            first = self.backend.extend(toks, write_rows, read_rows,
                                        m + k, tail)
        now = time.monotonic()
        with self._lock:
            if cfg.prefix_cache:
                if m + k:
                    self._prefix_hits += 1
                    self._prefix_reused_tokens += m + k
                else:
                    self._prefix_misses += 1
        req.first_token_t = now
        req.output.append(first)
        self._tokens_out += 1
        slot = _Slot(req, pages, eff, first)
        slot.last_token_t = now
        if cfg.prefix_cache:
            slot.prompt_tokens = list(t[:eff])
        if req.max_new_tokens <= 1:
            self._finish(slot, now)
            return True
        with self._lock:
            idx = next(i for i, s in enumerate(self._slots) if s is None)
            self._slots[idx] = slot
        return True

    def _step(self) -> None:
        cfg = self.config
        with self._lock:
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None]
        if not active:
            return
        tokens = np.zeros(cfg.slots, np.int32)
        positions = np.zeros(cfg.slots, np.int32)
        tables = np.zeros((cfg.slots, cfg.pages_per_slot()), np.int32)
        stepped = []
        for i, s in active:
            # Appending at position p needs block p//page allocated.
            blk = s.position // cfg.page_size
            if blk >= len(s.pages):
                with self._lock:
                    got = self._alloc_pages_locked(1)
                    if got is None:
                        continue  # out of pages: this slot skips the step
                    s.pages.append(got[0])
            tokens[i] = s.last_token
            positions[i] = s.position
            for b, pg in enumerate(s.pages):
                tables[i, b] = pg
            stepped.append((i, s))
        if not stepped:
            return
        nxt = self.backend.decode(tokens, positions, tables)
        now = time.monotonic()
        with self._lock:
            self._steps += 1
            self._batch_open = False
        for i, s in stepped:
            tok = nxt[i]
            s.req.output.append(tok)
            self._tokens_out += 1
            self._itl.append(now - s.last_token_t)
            s.last_token_t = now
            s.last_token = tok
            s.position += 1
            if len(s.req.output) >= s.req.max_new_tokens:
                if cfg.cont_batch:
                    # Vacate immediately: pages back to the pool, slot
                    # free for the next queued request on the NEXT step.
                    self._finish(s, now, slot_index=i)
                else:
                    # Static baseline: mark done but HOLD the slot (pad to
                    # the longest request); release at the batch boundary.
                    if not s.req.done.is_set():
                        s.req.finish_t = now
                        with self._lock:
                            self._completed += 1
                            self._window.append(
                                (now, s.req.ttft_s, s.req.latency_s,
                                 len(s.req.output)))
                        s.req.done.set()
        if not cfg.cont_batch:
            with self._lock:
                live = [s for s in self._slots if s is not None]
                if live and all(s.req.done.is_set() for s in live):
                    for i, s in enumerate(self._slots):
                        if s is not None:
                            self._release_slot_pages_locked(s)
                            self._slots[i] = None
                    self._batch_open = True

    def _finish(self, slot: _Slot, now: float,
                slot_index: Optional[int] = None) -> None:
        slot.req.finish_t = now
        with self._lock:
            self._completed += 1
            self._window.append((now, slot.req.ttft_s, slot.req.latency_s,
                                 len(slot.req.output)))
            self._release_slot_pages_locked(slot)
            if slot_index is not None:
                self._slots[slot_index] = None
        self._trace_request(slot.req)
        slot.req.done.set()

    def _trace_request(self, req: Request) -> None:
        """Emit the request's causal span chain (the request envelope with
        queue-wait, prefill and decode children) onto the job trace.
        Request clocks are monotonic; the offset to wall time is taken once
        here, so the spans line up with the cross-process timeline."""
        ctx = self._trace_ctx
        if ctx is None:
            return
        off = time.time() - time.monotonic()
        # A gateway-routed request carries the gw/route span id: parenting
        # under it joins the route and the serve work into one tree.
        parent = trace.add_span(
            "serve/request", req.submit_t + off,
            max(0.0, req.finish_t - req.submit_t), ctx=ctx,
            parent_id=req.trace_parent,
            request=req.id, tokens_out=len(req.output))
        if parent is None:
            return  # trace unsampled
        admit = req.admit_t or req.first_token_t or req.finish_t
        first = req.first_token_t or req.finish_t
        for name, t0, t1 in (("serve/queue_wait", req.submit_t, admit),
                             ("serve/prefill", admit, first),
                             ("serve/decode", first, req.finish_t)):
            trace.add_span(name, t0 + off, max(0.0, t1 - t0), ctx=ctx,
                           parent_id=parent.span_id, request=req.id)


# ---------------------------------------------------------------------------
# Executed-pod entrypoint
# ---------------------------------------------------------------------------

def _beat_loop(engine: ServeEngine, stop: threading.Event,
               interval_s: float = 0.25) -> None:
    rep = reporter()
    while not stop.wait(interval_s):
        st = engine.stats()
        rep.beat(step=st.step, examples_per_sec=st.tokens_per_sec,
                 phase=st.phase, serving=st.as_beat())


def main(argv: Optional[List[str]] = None) -> int:
    """JSON-lines TCP server over one ServeEngine.

    Request:  {"id": "r1", "prompt": [1,2,3], "max_new": 16}
    Response: {"id": "r1", "tokens": [...], "ttft_ms": ..., "error": ""}

    SIGTERM (the kubelet's drain/termination signal) closes intake,
    finishes in-flight requests, then exits 0 — the graceful-drain
    contract scale-down and rolling updates rely on.  ``--device``
    (default ``cuda``) places the model."""
    import argparse

    p = argparse.ArgumentParser(prog="kctpu-serve")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get(ENV_SERVE_PORT,
                                              DEFAULT_SERVE_PORT)))
    p.add_argument("--slots", type=int,
                   default=int(os.environ.get(ENV_SERVE_SLOTS, "8")))
    p.add_argument("--max-len", type=int,
                   default=int(os.environ.get(ENV_SERVE_MAX_LEN, "256")))
    p.add_argument("--no-cont-batch", action="store_true")
    p.add_argument("--prefix-cache", action="store_true",
                   default=os.environ.get(ENV_SERVE_PREFIX_CACHE) == "1",
                   help="cross-request prefix page sharing")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic backend (no model) — wiring tests")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (raises without CUDA "
                        "unless 'cpu' is given)")
    args = p.parse_args(argv)

    cfg = ServeConfig(slots=args.slots, max_len=args.max_len,
                      cont_batch=not args.no_cont_batch,
                      prefix_cache=args.prefix_cache)
    backend = (SyntheticBackend() if args.synthetic
               else LlamaBackend(LlamaConfig.tiny(), device=args.device))
    rep = reporter()
    # The kernels' build, up front and inside the compile window (the CPU
    # and the synthetic backend build nothing); the load beat carries its
    # source.
    source = "" if args.synthetic else build_kernels(backend.device, rep)
    rep.beat(step=0, phase=PHASE_LOAD, compile_source=source or None)
    engine = ServeEngine(backend, cfg)
    engine.start()

    stop = threading.Event()
    beats = threading.Thread(target=_beat_loop, args=(engine, stop),
                             name="serve-beats", daemon=True)
    beats.start()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                req = Request(id=str(msg.get("id", "")),
                              tokens=list(msg.get("prompt", [0])),
                              max_new_tokens=int(msg.get("max_new", 8)),
                              session=str(msg.get("session", "")),
                              tier=str(msg.get("tier", "standard")),
                              trace_parent=str(msg.get("trace_parent", "")))
                res = engine.submit(req)
                if res:
                    req.done.wait()
                else:
                    req.error = res.reason or "draining"
                out = {"id": req.id, "tokens": req.output,
                       "ttft_ms": round(req.ttft_s * 1e3, 3),
                       "error": req.error}
                self.wfile.write(json.dumps(out).encode() + b"\n")
                self.wfile.flush()

    class Server(socketserver.ThreadingTCPServer):
        daemon_threads = True
        allow_reuse_address = True

    srv = Server(("127.0.0.1", args.port), Handler)

    def on_term(signum, frame):
        # stop intake -> finish in-flight -> exit 0 (graceful drain).
        engine.drain()

        def _finish():
            engine._drained.wait(timeout=60.0)
            st = engine.stats()
            rep.beat(step=st.step, phase=PHASE_DRAIN, serving=st.as_beat())
            stop.set()
            srv.shutdown()

        t = threading.Thread(target=_finish, name="serve-drain-exit",
                             daemon=True)
        t.start()

    signal.signal(signal.SIGTERM, on_term)
    engine.wait_ready()
    st = engine.stats()
    rep.beat(step=st.step, phase=st.phase, serving=st.as_beat())
    print(f"serving on 127.0.0.1:{srv.server_address[1]} "
          f"(slots={cfg.slots}, cont_batch={cfg.cont_batch})", flush=True)
    try:
        srv.serve_forever(poll_interval=0.1)
    finally:
        stop.set()
        engine.stop()
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

