"""Continuous-batching decode engine over the paged KV cache (the
reference's ``serving/engine.py``).

Requests join and leave the decode batch mid-flight; prefill and decode
are disaggregated: each scheduling iteration runs at most a bounded number
of prefill chunks before the decode batch steps again.

A decode burst advances every lane ``burst_steps`` tokens on the device,
with EOS and length termination decided there (dead lanes emit -1 and
freeze); the host reads back once per burst to harvest tokens and retire
finished lanes. Burst batch shapes are rounded up to a small capture-size
menu (powers of two), the shapes a CUDA graph capture will key on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import dispatch
from .decode_plan import DecodePlanCache, make_provider
from .kv_cache import PagedKVCache
from .scheduler import FifoScheduler, capture_sizes, pick_capture


@dataclass
class Request:
    rid: Any
    prompt: Sequence[int]
    max_new: int
    eos: int = -1          # token id that stops generation; -1 = never


@dataclass
class _Lane:
    """Host-authoritative state of one in-flight decode lane."""
    rid: Any
    table: np.ndarray      # (n_blocks,) int32 physical page ids
    tok: int               # last emitted token (next step's input)
    pos: int               # absolute write position of `tok`
    rem: int               # tokens still allowed
    eos: int
    out: List[int] = field(default_factory=list)


@dataclass
class _Prefill:
    """A request mid-prefill (chunks consumed across iterations)."""
    req: Request
    table: np.ndarray
    start: int = 0
    logits: Optional[torch.Tensor] = None   # last chunk's final-token logits


class Engine:
    """Greedy-decoding continuous-batching engine.

    Usage::

        with Engine(lm, params, max_batch=8, max_len=256) as eng:
            outputs = eng.run([Request("a", [3, 5, 7], max_new=16)])

    ``outputs[rid]`` is the list of generated token ids (prompt excluded).
    ``params`` live on ``device``; serving expects them cast once with
    ``lm.serving_params``. While the engine is open it installs the
    decode-plan provider, so every MoE call of at most
    ``max(max_batch, prefill_chunk)`` tokens runs on a cached DecodePlan.
    """

    def __init__(self, lm, params, *, max_batch: int = 8, max_len: int = 256,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 burst_steps: int = 8, prefill_chunk: int = 16,
                 prefill_chunks_per_step: int = 2,
                 use_decode_plans: bool = True,
                 decode_plan_max_tokens: Optional[int] = None,
                 device="cuda"):
        self.lm = lm
        self.params = params
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.n_blocks = -(-max_len // page_size)
        if n_pages is None:
            n_pages = 1 + max_batch * self.n_blocks
        self.burst_steps = burst_steps
        self.prefill_chunk = prefill_chunk
        self.prefill_chunks_per_step = prefill_chunks_per_step
        self.capture_sizes = capture_sizes(max_batch)

        self.cache = lm.init_paged_cache(n_pages, page_size, device=self.device)
        self.kv = PagedKVCache(n_pages, page_size)
        self.sched = FifoScheduler()
        self.lanes: List[_Lane] = []
        self.outputs: Dict[Any, List[int]] = {}
        self._partial: Optional[_Prefill] = None
        self.stats = {"prefill_chunks": 0, "decode_steps": 0, "bursts": 0,
                      "completed": 0, "evicted": 0}

        self.plan_cache: Optional[DecodePlanCache] = None
        if use_decode_plans:
            self.plan_cache = DecodePlanCache()
            cap = (decode_plan_max_tokens if decode_plan_max_tokens is not None
                   else max(max_batch, prefill_chunk))
            dispatch.set_decode_provider(
                make_provider(self.plan_cache, max_tokens=cap))

    # --------------------------------------------------------------- teardown
    def close(self) -> None:
        if self.plan_cache is not None:
            dispatch.set_decode_provider(None)
            self.plan_cache = None

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        if not len(req.prompt):
            raise ValueError("empty prompt")
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid!r}: prompt+max_new "
                f"{len(req.prompt) + req.max_new} exceeds max_len "
                f"{self.max_len}")
        self.sched.submit(req)

    def cancel(self, rid) -> bool:
        """Evict an in-flight request; its partial output is kept."""
        for i, lane in enumerate(self.lanes):
            if lane.rid == rid:
                self.lanes.pop(i)
                self.kv.free(rid)
                self.outputs[rid] = lane.out
                self.stats["evicted"] += 1
                return True
        return False

    def has_work(self) -> bool:
        return bool(self.lanes or self.sched or self._partial is not None)

    # ---------------------------------------------------------------- prefill
    @torch.no_grad()    # serving never needs gradients, whatever the params
    def _prefill_one_chunk(self) -> None:
        p = self._partial
        prompt = np.asarray(p.req.prompt, np.int64)
        ln = min(self.prefill_chunk, len(prompt) - p.start)
        chunk = np.zeros((1, self.prefill_chunk), np.int64)
        chunk[0, :ln] = prompt[p.start:p.start + ln]
        p.logits, self.cache = self.lm.prefill_paged(
            self.params, torch.as_tensor(chunk, device=self.device), self.cache,
            torch.as_tensor(p.table[None], device=self.device), p.start, ln)
        p.start += ln
        self.stats["prefill_chunks"] += 1

    def _finish_prefill(self) -> None:
        p, self._partial = self._partial, None
        req = p.req
        t0 = int(torch.argmax(p.logits[0]).item())
        if t0 == req.eos or req.max_new <= 1:
            # EOS at step 0 (or a one-token budget): done without ever
            # joining the decode batch.
            self.outputs[req.rid] = [t0]
            self.kv.free(req.rid)
            self.stats["completed"] += 1
            return
        self.lanes.append(_Lane(rid=req.rid, table=p.table, tok=t0,
                                pos=len(req.prompt), rem=req.max_new - 1,
                                eos=req.eos, out=[t0]))

    def _admit(self) -> bool:
        """Start prefilling the next queued request if a lane and pages are
        available. Returns False on backpressure or an empty queue."""
        if self._partial is not None:
            return True
        if not self.sched or len(self.lanes) >= self.max_batch:
            return False
        req = self.sched.peek()
        total = len(req.prompt) + req.max_new
        if not self.kv.can_alloc(total):
            return False          # backpressure: wait for lanes to retire
        self.sched.pop()
        self.kv.alloc(req.rid, total)
        self._partial = _Prefill(req=req,
                                 table=self.kv.block_table(req.rid,
                                                           self.n_blocks))
        return True

    # ----------------------------------------------------------------- decode
    @torch.no_grad()
    def _burst(self, tok, pos, rem, live, eos, tables, steps: int):
        """``steps`` decode steps with termination decided on the device;
        returns (live (cap,), emitted (steps, cap)) still on the device."""
        emitted = []
        for _ in range(steps):
            logits, self.cache = self.lm.decode_step_paged(
                self.params, self.cache, tok, pos, tables)
            nxt = torch.argmax(logits, dim=-1)
            emitted.append(torch.where(live, nxt, -1))
            live_i = live.to(torch.int64)
            rem = rem - live_i
            live2 = live & ~((nxt == eos) | (rem <= 0))
            pos = pos + live_i
            tok = torch.where(live2, nxt, tok)
            live = live2
        return live, torch.stack(emitted)

    def decode_burst(self, steps: Optional[int] = None) -> int:
        """Advance every live lane up to ``steps`` tokens; retire finished
        lanes. Returns the number of tokens harvested."""
        if not self.lanes:
            return 0
        steps = self.burst_steps if steps is None else steps
        cap = pick_capture(len(self.lanes), self.capture_sizes)

        tok = np.zeros((cap,), np.int64)
        pos = np.zeros((cap,), np.int64)
        rem = np.zeros((cap,), np.int64)
        live = np.zeros((cap,), bool)
        eos = np.full((cap,), -1, np.int64)
        tables = np.zeros((cap, self.n_blocks), np.int32)
        for i, lane in enumerate(self.lanes):
            tok[i], pos[i], rem[i] = lane.tok, lane.pos, lane.rem
            live[i], eos[i], tables[i] = True, lane.eos, lane.table

        dev = self.device
        live_f, emitted = self._burst(
            torch.as_tensor(tok, device=dev), torch.as_tensor(pos, device=dev),
            torch.as_tensor(rem, device=dev), torch.as_tensor(live, device=dev),
            torch.as_tensor(eos, device=dev),
            torch.as_tensor(tables, device=dev), steps)
        # the ONE host readback for these `steps` decode steps
        both = torch.cat([emitted, live_f[None].to(emitted.dtype)]).cpu().numpy()
        emitted, live_f = both[:-1], both[-1].astype(bool)

        harvested = 0
        survivors: List[_Lane] = []
        for i, lane in enumerate(self.lanes):
            toks = emitted[:, i]
            toks = toks[toks >= 0]
            lane.out.extend(int(t) for t in toks)
            harvested += len(toks)
            if live_f[i]:
                lane.tok = int(toks[-1])
                lane.pos += len(toks)
                lane.rem -= len(toks)
                survivors.append(lane)
            else:
                self.outputs[lane.rid] = lane.out
                self.kv.free(lane.rid)
                self.stats["completed"] += 1
        self.lanes = survivors
        self.stats["decode_steps"] += steps
        self.stats["bursts"] += 1
        return harvested

    # ------------------------------------------------------------------ drive
    def step(self) -> None:
        """One scheduling iteration: a bounded number of prefill chunks, then
        one decode burst."""
        budget = self.prefill_chunks_per_step
        while budget > 0 and self._admit():
            self._prefill_one_chunk()
            budget -= 1
            if self._partial.start >= len(self._partial.req.prompt):
                self._finish_prefill()
        if self.lanes:
            self.decode_burst()

    def run(self, requests: Sequence[Request]) -> Dict[Any, List[int]]:
        """Submit ``requests``, drive to completion, return rid -> tokens."""
        for r in requests:
            self.submit(r)
        while self.has_work():
            self.step()
        return {r.rid: self.outputs[r.rid] for r in requests}
