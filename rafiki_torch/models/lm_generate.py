"""Paged-KV generative engine for :class:`TorchTransformerLM`.

The counterpart of ``rafiki_tpu/models/lm_generate.py``: the same
allocator, admission, prefix cache, eviction and counters, the same
numerics, on the port's devices.

- **Page pool.** Two preallocated bf16 tensors ``(L, n_pages·page_size,
  d)`` on the model's device, one for K and one for V, plus a host-side
  allocator (:class:`PagePool`). Pages are an allocator concept only:
  every program indexes the flat token slab by
  ``page·page_size + slot``. Physical page 0 is scratch: padded prompt
  rows and idle decode lanes write there, so the programs need no
  masking on their stores. Which of several writes to the same scratch
  row wins is undefined on the card; row 0 is never read unmasked.
- **Prefill** (bucketed prompt lengths): the model's own ``_block`` over
  the padded prompt, so the attention goes through K1 on the card; each
  layer's K and V rows are scattered into the sequence's pages in place
  (``index_copy_``), and the last valid position's f32 logits come out.
- **Decode** (one fixed shape): a single-token forward for
  ``decode_batch`` lanes that reads K/V through a gather of
  ``pages_per_seq`` page slots per lane, written with torch ops (the
  reference's decode is an XLA gather plus einsum, not a Pallas
  kernel). Sampling happens on the device: greedy argmax, or Gumbel
  noise from a stateless integer hash of ``(seed, position, vocab
  index)``, the same for any lane and any mix of sequences. On the card
  the step is captured once as a CUDA graph over static input buffers
  at construction (the counterpart of the reference's ahead-of-time
  compile); ``step`` fills the buffers and replays it. A failed capture
  raises: there is no eager decoding on the card.
- **Prefix reuse.** Prompt pages are read-only after prefill, so
  sequences with the same prompt share its full pages by refcount; a
  partial tail page is copied (one slice copy on the pools). Keyed by
  ``predictor.edge_cache.query_key`` over the token ids.

The engine is single-threaded by contract: the decode scheduler
(``worker/decode_scheduler.py``) is its only caller, from its own loop
thread.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF
from ..predictor.edge_cache import query_key
from .lm import _layer_norm
from .transformer import _sinusoidal

#: Prompt-length buckets: each distinct bucket is one prefill shape, so
#: the ladder is geometric.
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)

_M32 = 0xFFFFFFFF


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable — the admission gate."""


class PagePool:
    """Host-side refcounted page allocator over the device slab.

    Page 0 is reserved scratch (never handed out): fixed-shape
    programs direct padded/inactive writes there. ``retain`` is the
    prefix-sharing hook — a page is recycled only when its LAST
    holder frees it, so shared prompt pages survive any one
    sequence's exit. Single-page granularity means external
    fragmentation cannot exist: any free page serves any request.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # pop() -> low first
        self._ref: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def alloc(self) -> int:
        """One free page (refcount 1). Raises :class:`PoolExhausted`
        when none is left — callers gate admission or evict first."""
        if not self._free:
            raise PoolExhausted("page pool exhausted")
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def retain(self, page: int) -> None:
        if page not in self._ref:
            raise ValueError(f"retain of unallocated page {page}")
        self._ref[page] += 1

    def free(self, page: int) -> None:
        n = self._ref.get(page)
        if n is None:
            raise ValueError(f"free of unallocated page {page}")
        if n == 1:
            del self._ref[page]
            self._free.append(page)
        else:
            self._ref[page] = n - 1

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)


class _Seq:
    """One resident sequence's host-side state."""

    __slots__ = ("seq_id", "lane", "pages", "length", "prompt_len",
                 "last_token", "n_new", "max_new", "temperature",
                 "seed", "eos", "order", "tokens")

    def __init__(self, seq_id, lane, pages, length, prompt_len,
                 last_token, max_new, temperature, seed, eos, order,
                 tokens):
        self.seq_id = seq_id
        self.lane = lane              # decode-batch row
        self.pages = pages            # physical pages, logical order
        self.length = length          # tokens whose K/V are in the slab
        self.prompt_len = prompt_len
        self.last_token = last_token  # next decode input
        self.n_new = 1                # generated count (incl. last_token)
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.eos = eos
        self.order = order            # admission order (eviction picks max)
        self.tokens = tokens          # prompt + generated (for preemption)


def prefix_digest(tokens) -> str:
    """Content address of a token prefix: the edge cache's digest
    family applied to the token ids themselves."""
    return query_key(list(int(t) for t in tokens))


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash of int64 values in [0, 2^32);
    the multiplier keeps every product below 2^63."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor,
                 vocab_mix: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 standard Gumbel noise, a pure function of each lane's
    ``(seed, position)`` and the vocab index: no generator state, so the
    same draw comes out for any lane and any batch, and the decode step
    can be captured. ``vocab_mix`` is ``_mix32(arange(V))``."""
    h = _mix32(_mix32(seeds & _M32) ^ (positions & _M32))
    bits = _mix32(h[:, None] ^ vocab_mix[None, :])
    # 23 bits: (2k + 1)·2^-24 is exact in f32, strictly inside (0, 1).
    u = ((bits >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24
    return -torch.log(-torch.log(u))


class LMGenerator:
    """Continuous-batching generation engine over one loaded
    :class:`TorchTransformerLM`.

    Fixed shapes: ``decode_batch`` lanes × ``pages_per_seq`` page
    slots; one decode program serves any mix of lengths. ``admit``
    prefills a prompt into freshly-allocated pages (or reuses a cached
    prefix) and returns the first sampled token; ``step`` advances
    every resident sequence one token. ``step`` evicts the YOUNGEST
    resident sequence when a mid-step page allocation fails and reports
    it, so the scheduler can re-queue the preempted request (its tokens
    so far become the new prompt).
    """

    def __init__(self, model, *, page_size: int = 16,
                 n_pages: int = 128, decode_batch: int = 4,
                 max_new_cap: int = 256,
                 prefix_cache_entries: int = 16):
        if page_size < 1 or decode_batch < 1:
            raise ValueError("page_size and decode_batch must be >= 1")
        self._model = model
        self._dims = model._dims()
        self.device = model.device
        self.page_size = page_size
        self.n_pages = n_pages
        self.decode_batch = decode_batch
        self.max_new_cap = max_new_cap
        # Per-lane page-slot budget: enough for a full-length prompt
        # plus the generation cap, rounded up to pages.
        self.pages_per_seq = max(
            1, -(-(self._dims["t"] + max_new_cap) // page_size))
        self.max_tokens = self.pages_per_seq * page_size
        self.pool = PagePool(n_pages)
        s, dev = self._dims, self.device
        self._w = model._weights()     # the model's bf16 casts
        slab = n_pages * page_size
        self._k_pool = torch.zeros((s["layers"], slab, s["d"]),
                                   dtype=torch.bfloat16, device=dev)
        self._v_pool = torch.zeros_like(self._k_pool)
        # One position table for the prefill buckets and the decode
        # positions: row i of the sinusoidal table does not depend on
        # its length.
        rows = max(PREFILL_BUCKETS[-1], self.max_tokens)
        self._pe = torch.from_numpy(_sinusoidal(rows, s["d"])).to(
            dev, torch.bfloat16)
        self._sqrt_d = torch.tensor(math.sqrt(s["d"]),
                                    dtype=torch.bfloat16, device=dev)
        self._seqs: Dict[Any, _Seq] = {}
        self._lanes: List[Optional[Any]] = [None] * decode_batch
        self._order = 0
        #: digest -> (pages, n_full, prompt_len, first_logits np)
        self._prefix: "Dict[str, Tuple[List[int], int, int, np.ndarray]]" = {}
        self._prefix_lru: List[str] = []
        self._prefix_cap = max(0, prefix_cache_entries)
        self.prefills_total = 0
        self.prefill_skipped_total = 0
        self.decode_steps_total = 0
        self.tokens_total = 0
        self.evictions_total = 0
        self.last_logits: Dict[Any, np.ndarray] = {}
        self._build_decode_inputs()
        # The decode step is the per-token hot path: capture it at
        # construction, not under the first request.
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        if dev.type == "cuda":
            self._capture_decode()

    # ---- the decode program ----

    def _build_decode_inputs(self) -> None:
        """Static decode inputs on the device and their host staging
        (pinned on the card): per lane ``[id, length, seed, slots...]``
        as int64, and the temperatures as f32."""
        B, P, dev = self.decode_batch, self.pages_per_seq, self.device
        pin = dev.type == "cuda"
        self._host_int = torch.zeros((B, P + 3), dtype=torch.int64,
                                     pin_memory=pin)
        self._host_temp = torch.zeros((B,), dtype=torch.float32,
                                      pin_memory=pin)
        self._in_int = torch.zeros((B, P + 3), dtype=torch.int64,
                                   device=dev)
        self._in_temp = torch.zeros((B,), dtype=torch.float32, device=dev)
        self._slot_offsets = torch.arange(self.page_size, device=dev)
        self._t_range = torch.arange(self.max_tokens, device=dev)
        self._vocab_mix = _mix32(torch.arange(self._dims["v"],
                                              dtype=torch.int64,
                                              device=dev))

    def _decode_args(self):
        x = self._in_int
        return x[:, 0], x[:, 3:], x[:, 1], self._in_temp, x[:, 2]

    @torch.no_grad()
    def _decode(self, ids, slots, lengths, temps, seeds):
        """One decode step for ``B`` lanes: ``(next_ids, logits)``, with
        each lane's new K and V written into the pools before the
        gather of the same layer. The rounding points are the
        reference's: bf16 products of q and the gathered K (its einsum),
        the scores cast to f32 and scaled, a finite ``NEG_INF`` mask, an
        f32 softmax cast to bf16, a bf16 product with the gathered V."""
        s, w, net = self._dims, self._w, self._model._net
        d, h = s["d"], s["h"]
        dh = d // h
        ps, B, T = self.page_size, self.decode_batch, self.max_tokens
        x = w["embed"][ids] * self._sqrt_d + self._pe[lengths]   # (B, d)
        # The incoming token's slot, and the gather map of each lane's
        # whole logical sequence. Idle lanes (length 0, slots 0) write
        # and read the scratch page; the mask keeps it out of real
        # lanes and the host discards idle lanes' outputs.
        write_pos = (slots.gather(1, (lengths // ps)[:, None])[:, 0] * ps
                     + lengths % ps)
        gather = (slots[:, :, None] * ps
                  + self._slot_offsets[None, None, :]).reshape(B, T)
        kv_mask = self._t_range[None, :] <= lengths[:, None]
        for i, blk in enumerate(net.blocks):
            p = f"blocks.{i}."
            hid = _layer_norm(x, blk.ln1).to(torch.bfloat16)
            q, k_new, v_new = F.linear(hid, w[p + "qkv.weight"]).split(
                d, dim=-1)
            kp, vp = self._k_pool[i], self._v_pool[i]
            kp.index_copy_(0, write_pos, k_new)
            vp.index_copy_(0, write_pos, v_new)
            # Each lane's gathered (T, h, dh) rows are read as h strided
            # (T, dh) matrices, one batched product per lane. Gathering
            # straight into head-major (h, B, T, dh) order for one product
            # over h·B was slower on the H100: PyTorch's index kernel for
            # that layout is several times slower than its row gather.
            kh = kp[gather].view(B, T, h, dh).transpose(1, 2)
            vh = vp[gather].view(B, T, h, dh).transpose(1, 2)
            qh = q.reshape(B, h, dh, 1)
            sc = torch.stack([torch.bmm(kh[b], qh[b]) for b in range(B)])
            sc = sc[..., 0].float() / math.sqrt(dh)               # (B, h, T)
            sc = torch.where(kv_mask[:, None, :], sc, NEG_INF)
            pr = torch.softmax(sc, dim=-1).to(torch.bfloat16)[:, :, None]
            o = torch.stack([torch.bmm(pr[b], vh[b])
                             for b in range(B)]).reshape(B, d)
            x = x + F.linear(o, w[p + "proj.weight"]).to(x.dtype)
            hid = _layer_norm(x, blk.ln2).to(torch.bfloat16)
            hid = F.gelu(F.linear(hid, w[p + "w1.weight"]),
                         approximate="tanh")
            x = x + F.linear(hid, w[p + "w2.weight"]).to(x.dtype)
        x = _layer_norm(x, net.lnf).to(torch.bfloat16)
        logits = (x @ w["embed"].T).float()                      # (B, V)
        greedy = logits.argmax(-1)
        # The noise is folded from the POSITION, not the lane: the same
        # (seed, position) draws the same noise however admission
        # packed the batch.
        noise = gumbel_noise(seeds, lengths, self._vocab_mix)
        sampled = (logits / temps.clamp(min=1e-6)[:, None]
                   + noise).argmax(-1)
        return torch.where(temps > 0.0, sampled, greedy), logits

    def _capture_decode(self) -> None:
        """Capture the decode step as a CUDA graph over the static
        inputs, after two warm-up runs on a side stream (all lanes idle:
        they write the scratch page only). The graph allocates from its
        own memory pool."""
        args = self._decode_args()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(2):
                self._decode(*args)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._decode(*args)
        self._graph, self._out = graph, out

    def _stage_inputs(self) -> None:
        """Copy the resident sequences' ids, slots, lengths, seeds and
        temperatures into the static decode inputs; idle lanes get
        zeros. The host buffers are rewritten only after the previous
        step's results came back, so its copies have completed."""
        host = self._host_int.numpy()
        temps = self._host_temp.numpy()
        host.fill(0)
        temps.fill(0.0)
        for seq in self._seqs.values():
            row = host[seq.lane]
            # The noise hashes the seed's low 32 bits, which fit int64.
            row[0], row[1] = seq.last_token, seq.length
            row[2] = seq.seed & _M32
            row[3:3 + len(seq.pages)] = seq.pages
            temps[seq.lane] = seq.temperature
        pinned = self._host_int.is_pinned()
        self._in_int.copy_(self._host_int, non_blocking=pinned)
        self._in_temp.copy_(self._host_temp, non_blocking=pinned)

    def _run_decode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._graph is not None:
            self._graph.replay()
            return self._out
        return self._decode(*self._decode_args())

    # ---- admission ----

    def resident(self) -> int:
        return len(self._seqs)

    def pool_used_ratio(self) -> float:
        usable = self.pool.n_pages - 1
        return self.pool.used_pages / usable if usable else 0.0

    def resident_tokens(self) -> int:
        """Tokens whose K/V is live in the paged cache right now."""
        return sum(s.length for s in self._seqs.values())

    def _pages_needed(self, prompt_len: int) -> int:
        return -(-max(1, prompt_len + 1) // self.page_size)

    def can_admit(self, prompt_len: int) -> bool:
        """Admission gate: a free lane AND enough pages for the prompt
        plus the first generated token (prefix-cache hits need fewer,
        but the gate stays conservative — a hit only helps). Reclaims
        cache-held prefix pages (LRU) when short: LIVE sequences
        always outrank cached prefixes for pool space."""
        if len(self._seqs) >= self.decode_batch:
            return False
        need = self._pages_needed(prompt_len)
        if self.pool.free_pages < need:
            self._reclaim_prefix(need)
        return self.pool.free_pages >= need

    def _alloc_page(self) -> int:
        """Pool alloc that spills the prefix cache before failing."""
        try:
            return self.pool.alloc()
        except PoolExhausted:
            self._reclaim_prefix(1)
            return self.pool.alloc()

    def _reclaim_prefix(self, want_pages: int) -> None:
        """Drop LRU prefix-cache entries until ``want_pages`` pages
        are free (or the cache is empty). Shared pages only lose the
        cache's reference — sequences still decoding over them are
        untouched."""
        while self.pool.free_pages < want_pages and self._prefix_lru:
            digest = self._prefix_lru.pop(0)
            pages, _nf, _pl, _lg = self._prefix.pop(digest)
            for p in pages:
                self.pool.free(p)

    def admit(self, tokens: List[int], *, max_new: int,
              temperature: float = 0.0, seed: int = 0,
              eos: Optional[int] = None, seq_id: Any = None
              ) -> Tuple[Any, int]:
        """Prefill (or prefix-reuse) one prompt and return
        ``(seq_id, first_token)``. Raises :class:`PoolExhausted` when
        ``can_admit`` would be False — callers gate first."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("empty prompt")
        # An id outside the table would fault the device's gather (and
        # with it every later launch), where the reference clamps.
        if min(tokens) < 0 or max(tokens) >= self._dims["v"]:
            raise ValueError(f"token ids must lie in [0, {self._dims['v']})")
        if len(tokens) + 1 > self.max_tokens:
            tokens = tokens[-(self.max_tokens - max(1, max_new)):]
        max_new = max(1, min(int(max_new), self.max_new_cap,
                             self.max_tokens - len(tokens)))
        lane = next((i for i, s in enumerate(self._lanes)
                     if s is None), None)
        if lane is None or not self.can_admit(len(tokens)):
            raise PoolExhausted("no lane/pages for admission")
        digest = prefix_digest(tokens)
        hit = self._prefix.get(digest)
        if hit is not None:
            pages, first_logits = self._adopt_prefix(hit)
            self.prefill_skipped_total += 1
        else:
            pages, first_logits = self._prefill(tokens)
            self._insert_prefix(digest, pages, len(tokens),
                                first_logits)
        first = self._sample_host(first_logits, temperature, seed,
                                  len(tokens))
        if seq_id is None:
            seq_id = f"seq-{self._order}"
        seq = _Seq(seq_id, lane, pages, len(tokens), len(tokens),
                   first, max_new, float(temperature), int(seed), eos,
                   self._order, tokens + [first])
        self._order += 1
        self._lanes[lane] = seq_id
        self._seqs[seq_id] = seq
        self.last_logits[seq_id] = first_logits
        self.tokens_total += 1
        return seq_id, first

    def _prefill(self, tokens: List[int]
                 ) -> Tuple[List[int], np.ndarray]:
        n = len(tokens)
        pages = [self._alloc_page()
                 for _ in range(self._pages_needed(n))]
        bucket = next((b for b in PREFILL_BUCKETS if b >= n),
                      PREFILL_BUCKETS[-1])
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = tokens
        pos = np.zeros((bucket,), np.int64)  # padding -> scratch page 0
        i = np.arange(n)
        pos[:n] = (np.asarray(pages, np.int64)[i // self.page_size]
                   * self.page_size + i % self.page_size)
        logits = self._run_prefill(torch.from_numpy(ids).to(self.device),
                                   torch.from_numpy(pos).to(self.device),
                                   n - 1)
        self.prefills_total += 1
        return pages, logits.cpu().numpy()

    @torch.no_grad()
    def _run_prefill(self, ids: torch.Tensor, pos: torch.Tensor,
                     last: int) -> torch.Tensor:
        """The prompt through the model's own blocks (K1 on the card),
        each layer's K and V rows into the pools at ``pos``; the f32
        logits of position ``last``."""
        m, s, w = self._model, self._dims, self._w
        x = w["embed"][ids] * self._sqrt_d
        x = x + self._pe[None, :ids.shape[1]]
        for i in range(s["layers"]):
            kv: List[Tuple[torch.Tensor, torch.Tensor]] = []
            x = m._block(x, w.__getitem__, i, s["h"], kv=kv)
            (k, v), = kv
            self._k_pool[i].index_copy_(0, pos, k[0])
            self._v_pool[i].index_copy_(0, pos, v[0])
        xl = _layer_norm(x[0, last], m._net.lnf).to(torch.bfloat16)
        return (xl @ w["embed"].T).float()

    # ---- prefix cache ----

    def _insert_prefix(self, digest: str, pages: List[int],
                       prompt_len: int, logits: np.ndarray) -> None:
        if self._prefix_cap <= 0 or digest in self._prefix:
            return
        for p in pages:
            self.pool.retain(p)  # the cache's own reference
        n_full = prompt_len // self.page_size
        self._prefix[digest] = (list(pages), n_full, prompt_len,
                                logits)
        self._prefix_lru.append(digest)
        while len(self._prefix_lru) > self._prefix_cap:
            old = self._prefix_lru.pop(0)
            old_pages, _nf, _pl, _lg = self._prefix.pop(old)
            for p in old_pages:
                self.pool.free(p)

    def _adopt_prefix(self, hit) -> Tuple[List[int], np.ndarray]:
        """Share the hit's full pages by refcount; copy a partial tail
        page (decode will append INTO it)."""
        pages, n_full, _prompt_len, logits = hit
        out: List[int] = []
        for p in pages[:n_full]:
            self.pool.retain(p)
            out.append(p)
        for p in pages[n_full:]:  # at most one partial tail page
            dst = self._alloc_page()
            self._copy_page(p, dst)
            out.append(dst)
        return out, logits

    def _copy_page(self, src: int, dst: int) -> None:
        ps = self.page_size
        for pool in (self._k_pool, self._v_pool):
            pool[:, dst * ps:(dst + 1) * ps] = pool[:, src * ps:
                                                    (src + 1) * ps]

    # ---- decode ----

    def _ensure_page(self, seq: _Seq) -> bool:
        """Make sure the slot for position ``seq.length`` exists.
        False = allocation failed (pool pressure)."""
        need = seq.length // self.page_size
        if need < len(seq.pages):
            return True
        try:
            seq.pages.append(self._alloc_page())
            return True
        except PoolExhausted:
            return False

    def evict_youngest(self) -> Optional[Dict[str, Any]]:
        """Preempt the most recently admitted resident sequence: free
        its pages and return enough state to re-queue it (tokens so
        far become the new prompt; generated count carries so the
        budget is honored across the preemption)."""
        if not self._seqs:
            return None
        seq = max(self._seqs.values(), key=lambda s: s.order)
        self._release(seq)
        self.evictions_total += 1
        return {"seq_id": seq.seq_id, "tokens": list(seq.tokens),
                "n_done": seq.n_new, "max_new": seq.max_new,
                "temperature": seq.temperature, "seed": seq.seed,
                "eos": seq.eos}

    def finish(self, seq_id: Any) -> None:
        seq = self._seqs.get(seq_id)
        if seq is not None:
            self._release(seq)

    def _release(self, seq: _Seq) -> None:
        for p in seq.pages:
            self.pool.free(p)
        self._lanes[seq.lane] = None
        del self._seqs[seq.seq_id]
        # last_logits deliberately survives release: the finishing
        # step's logits are read AFTER the sequence is gone (parity
        # checks, the scheduler's final frame); pruned in step().

    def step(self) -> Tuple[List[Tuple[Any, int, Optional[str]]],
                            List[Dict[str, Any]]]:
        """One decode step for every resident sequence.

        Returns ``(results, evicted)``: results are
        ``(seq_id, token, finish)`` triples — ``finish`` is ``None``
        (still going), ``"eos"`` or ``"length"`` — and ``evicted``
        lists preempted-sequence states (pool pressure made room for
        the sequences that DID step).
        """
        evicted: List[Dict[str, Any]] = []
        # Page pressure: every stepping sequence needs its write slot;
        # evict youngest-first until the remaining set fits.
        while True:
            ordered = sorted(self._seqs.values(), key=lambda s: s.order)
            if all(self._ensure_page(s) for s in ordered):
                break
            ev = self.evict_youngest()
            if ev is None:
                break
            evicted.append(ev)
        if not self._seqs:
            return [], evicted
        self._stage_inputs()
        next_ids, logits = self._run_decode()
        self.decode_steps_total += 1
        next_host = next_ids.cpu().numpy()
        logits_host = logits.cpu().numpy()
        results: List[Tuple[Any, int, Optional[str]]] = []
        for seq in list(self._seqs.values()):
            tok = int(next_host[seq.lane])
            seq.length += 1          # last_token's K/V is now in-slab
            seq.last_token = tok
            seq.n_new += 1
            seq.tokens.append(tok)
            self.tokens_total += 1
            self.last_logits[seq.seq_id] = logits_host[seq.lane]
            finish = None
            if seq.eos is not None and tok == seq.eos:
                finish = "eos"
            elif seq.n_new >= seq.max_new:
                finish = "length"
            results.append((seq.seq_id, tok, finish))
            if finish is not None:
                self._release(seq)
        while len(self.last_logits) > 8 * self.decode_batch:
            self.last_logits.pop(next(iter(self.last_logits)))
        return results, evicted

    # ---- host sampling (first token, from prefill logits) ----

    @staticmethod
    def _sample_host(logits: np.ndarray, temperature: float,
                     seed: int, position: int) -> int:
        if temperature <= 0:
            return int(np.argmax(logits))
        rng = np.random.default_rng((int(seed) << 20) ^ position)
        g = rng.gumbel(size=logits.shape)
        return int(np.argmax(logits / max(temperature, 1e-6) + g))

    def close(self) -> None:
        for seq_id in list(self._seqs):
            self.finish(seq_id)
        for digest in list(self._prefix_lru):
            pages, _nf, _pl, _lg = self._prefix.pop(digest)
            for p in pages:
                self.pool.free(p)
        self._prefix_lru.clear()
        self._graph = self._out = None
        self._k_pool = self._v_pool = None
