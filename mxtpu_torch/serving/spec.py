"""Speculative multi-token decode — the draft side of draft-and-verify.

Port of ``mxtpu/serving/spec.py``. A speculative decode turn has two
halves with an exact greedy contract between them:

* **draft** (this module, on the host) — a :class:`Drafter` proposes up to
  ``k`` tokens a slot; a miss proposes nothing and the slot runs a plain
  decode step inside the same verify program (``dlen == 0``).
* **verify** (``kv.build_verify``, on the device) — one forward scores all
  ``k + 1`` positions of every slot; the accepted prefix is the run of
  drafts the model itself would have produced, plus one token past them,
  so greedy output equals plain decode whatever the drafter proposes.

:class:`NgramDrafter`, the default, needs no second model: the request's
own stream first (prompt-lookup decoding), then the
:meth:`~mxtpu_torch.serving.kv.PrefixCache.ngram_lookup` index over the
prefix cache's token paths. :class:`ModelDrafter` continues the context
with a small ``transformer_lm``.

Turn it on with ``ServingEngine(spec=SpecConfig(k=...))``, the
``ServingConfig.spec`` field, or ``MXTPU_SPEC_DECODE=<k>``; off by
default.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import torch

__all__ = ["SpecConfig", "parse_spec", "spec_from_env", "Drafter",
           "NgramDrafter", "ModelDrafter"]


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode configuration of one engine. ``k`` is the draft
    depth (the verify program scores ``k + 1`` positions and is keyed on
    (slots, KV bucket, k)); ``ngram`` / ``min_ngram`` bound the suffix the
    default drafter matches (longest first) and ``scan`` how far back its
    self-context search walks; ``drafter`` replaces the default
    :class:`NgramDrafter`."""
    k: int = 4
    ngram: int = 3
    min_ngram: int = 2
    scan: int = 1024
    drafter: Optional["Drafter"] = None

    def __post_init__(self):
        if not 1 <= self.k <= 16:
            raise ValueError(f"spec draft depth k must be in 1..16, "
                             f"got {self.k}")
        if not 1 <= self.min_ngram <= self.ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= ngram, got "
                f"min_ngram={self.min_ngram} ngram={self.ngram}")


def parse_spec(value) -> Optional[SpecConfig]:
    """Parse ``MXTPU_SPEC_DECODE`` / ``ServingEngine(spec=...)``: a
    :class:`SpecConfig` passes through, an int (or int string) is the draft
    depth ``k``, None / '' / 0 disables. Anything else raises."""
    if value is None or value == "":
        return None
    if isinstance(value, SpecConfig):
        return value
    try:
        k = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"spec must be a SpecConfig or an integer draft depth, "
            f"got {value!r}") from None
    return SpecConfig(k=k) if k > 0 else None


def spec_from_env() -> Optional[SpecConfig]:
    """The environment's word in the engine's resolution chain (argument >
    ``ServingConfig.spec`` > ``MXTPU_SPEC_DECODE``)."""
    return parse_spec(os.environ.get("MXTPU_SPEC_DECODE"))


class Drafter:
    """The proposer seam: ``propose(context, k)`` returns up to ``k`` token
    ids predicted to follow ``context`` (the request's prompt and generated
    tokens, oldest first), ``[]`` on a miss. Called on the engine's
    scheduler thread between dispatches, for greedy slots only."""

    def propose(self, context: List[int], k: int) -> List[int]:
        raise NotImplementedError

    def stats(self) -> dict:
        """Optional counters of the drafter."""
        return {}


class NgramDrafter(Drafter):
    """Model-free proposer: the stream's own suffix first, then the
    :class:`~mxtpu_torch.serving.kv.PrefixCache` n-gram index.

    The self-context pass finds the latest earlier occurrence of the
    stream's final ``n`` tokens (``n`` from ``ngram`` down to
    ``min_ngram``, searching at most ``scan`` positions back) and proposes
    what followed it. On a miss the prefix cache's index answers from
    every cached prompt path. Either source may be absent."""

    def __init__(self, prefix_cache=None, ngram: int = 3, min_ngram: int = 2,
                 scan: int = 1024):
        self._prefix = prefix_cache
        self.ngram = int(ngram)
        self.min_ngram = int(min_ngram)
        self.scan = int(scan)

    @classmethod
    def from_config(cls, cfg: SpecConfig, prefix_cache=None):
        return cls(prefix_cache=prefix_cache, ngram=cfg.ngram,
                   min_ngram=cfg.min_ngram, scan=cfg.scan)

    def propose(self, context: List[int], k: int) -> List[int]:
        if k <= 0 or not context:
            return []
        got = self._self_lookup(context, k)
        if got:
            return got
        if self._prefix is not None:
            return self._prefix.ngram_lookup(context[-self.ngram:], k)
        return []

    def _self_lookup(self, context: List[int], k: int) -> List[int]:
        L = len(context)
        for n in range(min(self.ngram, L - 1), self.min_ngram - 1, -1):
            pat = context[L - n:]
            lo = max(0, L - n - self.scan)
            for s in range(L - n - 1, lo - 1, -1):
                if context[s:s + n] == pat:
                    cont = context[s + n:s + n + k]
                    if cont:
                        return list(cont)
        return []


class ModelDrafter(Drafter):
    """Draft-model proposer: a small ``transformer_lm`` continues the
    slot's context greedily (its own ``generate``, apart from the engine's
    programs), under the same advisory verify contract as the n-gram
    drafter. The context is cut from the left to the largest of
    ``buckets`` that fits, which bounds the draft model's cache shapes; a
    context shorter than the smallest bucket proposes nothing.

    Use ``SpecConfig(k=..., drafter=ModelDrafter(draft_net))``."""

    BUCKETS = (8, 32, 64)

    def __init__(self, model, buckets=BUCKETS):
        self._model = model
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad draft buckets {buckets!r}")
        self.calls = 0
        self.proposed = 0

    def propose(self, context: List[int], k: int) -> List[int]:
        if k <= 0:
            return []
        b = 0
        for cand in self.buckets:
            if cand <= len(context):
                b = cand
        if b == 0 or b + k > self._model._max_len:
            return []
        tail = torch.tensor([context[-b:]], dtype=torch.long)
        out = self._model.generate(tail, k)
        toks = out[0, b:].tolist()
        self.calls += 1
        self.proposed += len(toks)
        return toks

    def stats(self) -> dict:
        return {"draft_lm_calls": self.calls,
                "draft_lm_tokens": self.proposed}
