"""Batched prefill admission: several pending prompts, one chunk program.

Port of ``mxtpu/sched/admission.py``. The plain engine prefills one prompt
at a time through a B=1 chunk program; under a burst that serializes the
time to first token across the wave. Here up to ``N`` pending prompts are
packed into the rows of one chunk program instead:

* the program (a :class:`~mxtpu_torch.serving.kv.ChunkProgram`, captured
  once on the card and replayed) is keyed ``("batch", N, PB, csize)``: N is
  the engine's ``prefill_batch`` (short groups are padded with inert rows)
  and PB the group's largest prompt bucket, so no mix of prompts builds a
  new program;
* each row's prompt length ``t0``, bucket ``pb``, previous token, last fed
  token and sampling triple are values of the program's state, and all rows
  share one position cursor, starting at the shallowest member's prefix
  match (rounded down to a 32-token block). A deeper match recomputes its
  cached span, forced prompt positions whose rewritten K/V rows are the
  cached ones;
* a row is live while its position is below its own bucket ``pb``; past it
  (and on padding rows) it re-feeds the token it last fed at position
  ``pb - 1``, an identical rewrite. So each member prefills exactly the
  positions the plain engine's B=1 prefill would (the reference runs every
  row to the group's PB), and decode takes over at the same position.

Each row gets the bits of the plain engine's B=1 prefill step: the step is
``quant.serve.build_step(..., rowwise=True)`` (float products one row at a
time, int8 products flattened, K5 at S = N rows with its chunks planned for
one row, the float-cache read one row at a time), and a step's bits do not
depend on its bucket (K5's ``span``). The cross-chunk carry is (page, prev,
lastfed), so the chunks run back to back reproduce each member's prefill
token for token. :class:`PrefillGroup` holds the host-side cursors; the
engine dispatches one chunk a scheduler turn.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..quant import kv_quant as qkv
from ..quant.serve import QuantSpec, build_step
from ..serving import kv

__all__ = ["build_prefill_batch", "PrefillGroup"]


def build_prefill_batch(model, params, page, N: int, PB: int, csize: int,
                        quant=None, pool=None,
                        decode_kernel=None) -> kv.ChunkProgram:
    """The batched prefill chunk program for (rows ``N``, group bucket
    ``PB``, ``csize`` positions) over the group ``page`` ``(L, 2, N, H, PB,
    D)``, updated in place.

    Call: ``prog(prompts (N, PB) ints, t0 (N,), pb (N,), start, prev (N,),
    lastfed (N,), temp (N,), topk (N,), seed (N,)) -> (prev, lastfed, outs
    (csize, N))`` where ``outs[j, n]`` is row ``n``'s token for position
    ``start + j + 1``; the valid generated tokens of a chunk are those with
    ``t0 - 1 <= start + j < pb`` (decided on the host). ``prompts`` may be
    a tensor on the program's device (one device-to-device copy a call) or
    a host array. ``decode_kernel`` pins the quantized cache's read."""
    step = build_step(model, N, PB, quant or QuantSpec(), rowwise=True,
                      decode_kernel=decode_kernel)
    sample = model.serving_sample()
    dev = params["pos"].device
    state = torch.zeros((8, N), dtype=torch.float64, device=dev)
    prompts = torch.zeros((N, PB), dtype=torch.long, device=dev)
    out = torch.zeros((csize + 2, N), dtype=torch.long, device=dev)

    def body(steps: int = csize):
        ints = state.long()
        t0, pb, start, prev, lastfed, topk, seed = ints[:7].unbind(0)
        temp = state[7].float()
        outs = []
        for j in range(steps):
            t = start + j
            live = t < pb
            pos = torch.minimum(t, pb - 1)
            ptok = prompts.gather(1, pos[:, None])[:, 0]
            fed = torch.where(live, torch.where(t < t0, ptok, prev), lastfed)
            _, logits = step(params, page, fed, pos)
            nxt = sample(logits, temp, topk, seed, pos)
            prev = torch.where(live, nxt, prev)
            lastfed = torch.where(live, fed, lastfed)
            outs.append(nxt)
        out[:steps].copy_(torch.stack(outs))
        out[csize].copy_(prev)
        out[csize + 1].copy_(lastfed)

    def pack(prompts_, t0, pb, start, prev, lastfed, temp, topk, seed):
        return np.stack([t0, pb, np.full(N, start), prev, lastfed, topk,
                         np.asarray(seed) & 0xFFFFFFFF, temp]).astype(
                             np.float64)

    def load(prompts_, *_):
        prompts.copy_(torch.as_tensor(prompts_), non_blocking=True)

    def unpack(o):
        return o[csize], o[csize + 1], o[:csize]

    return kv.ChunkProgram(body, state, out, pack, unpack, pool, load)


class PrefillGroup:
    """Host-side state of one in-flight batched prefill.

    ``members`` are the engine's per-request dicts (``req``, ``slot``,
    ``t0`` (forced below), ``emit`` (the first position to deliver),
    ``start`` (prefix-match length), ``blocks`` (cached K/V rows,
    consumed here), ``left``, ``done``, the sampling triple); row ``n``
    belongs to ``members[n]``, rows past ``len(members)`` are padding.
    ``page`` is the group page the engine's ``("batch", N, PB, csize)``
    programs were built over (reset here); ``staged`` the members' prompts,
    each a ``(PB_m,)`` tensor on the page's device."""

    def __init__(self, model, members: List[dict], N: int, PB: int, page,
                 staged: List[torch.Tensor]):
        if not members or len(members) > N:
            raise ValueError(f"bad group size {len(members)} for batch {N}")
        self.members = members
        self.N, self.PB = N, PB
        dev = getattr(page, "data", page).device
        prompts = torch.zeros((N, PB), dtype=torch.long, device=dev)
        self.t0 = np.full(N, PB, np.int64)
        self.emit = np.full(N, PB, np.int64)
        self.pb = np.full(N, PB, np.int64)
        self.temp = np.zeros(N, np.float32)
        self.topk = np.zeros(N, np.int64)
        self.seed = np.zeros(N, np.int64)
        self.page = kv.reset_page(page)
        for n, (mem, prompt) in enumerate(zip(members, staged)):
            prompts[n, :prompt.shape[0]] = prompt
            self.t0[n] = mem["t0"]
            self.emit[n] = mem["emit"]
            self.pb[n] = prompt.shape[0]
            self.temp[n], self.topk[n], self.seed[n] = (
                mem["temp"], mem["topk"], mem["seed"])
            blocks = mem.pop("blocks", None)
            if mem["start"] and blocks:
                kv.install_rows(qkv.slot_page(page, n), blocks,
                                mem["start"])
        self.prompts = prompts
        self.prev = np.zeros(N, np.int64)
        self.lastfed = np.zeros(N, np.int64)
        # the shallowest member's match, aligned down to the 32-token block
        # grid: a partial-block tail is re-fed as an identical rewrite, and
        # the aligned cursor keeps the program keys to PB / 32 chunk sizes
        lo = min(mem["start"] for mem in members)
        self.cursor = lo - (lo % kv.PrefixCache.BLOCK)

    def remaining(self) -> int:
        """Positions still to run before every member row is done."""
        return max(self.PB - self.cursor, 0)

    def chunk_inputs(self):
        """The arguments of one :func:`build_prefill_batch` call at the
        current cursor."""
        return (self.prompts, self.t0, self.pb, self.cursor, self.prev,
                self.lastfed, self.temp, self.topk, self.seed)

    def valid_range(self, n: int, csize: int):
        """Member ``n``'s emitted tokens of the chunk just run: ``(j_lo,
        j_hi)`` into ``outs[:, n]`` (empty when ``j_lo >= j_hi``), the
        tokens with ``emit - 1 <= cursor + j < pb`` (``emit``, the first
        position to deliver, is ``t0`` unless the member replays forced
        tokens)."""
        j_lo = max(int(self.emit[n]) - 1 - self.cursor, 0)
        j_hi = min(csize, int(self.pb[n]) - self.cursor)
        return j_lo, j_hi

    def advance(self, prev, lastfed, csize: int) -> None:
        self.prev, self.lastfed = np.array(prev), np.array(lastfed)
        self.cursor += csize

    def member_page(self, n: int):
        """A copy of row ``n``'s finished ``(L, 2, 1, H, pb, D)`` page."""
        return qkv.block_slice(qkv.slot_page(self.page, n), 0,
                               int(self.pb[n]))
