"""The host side of the tensor-parallel kernels across cards: one rank a
card, P cards in one process (counterpart of the cross-chip form of
sparch_tpu/ops/pallas_tp.py, whose P chips exchange by remote DMA).

The kernels (``csrc/tp_collectives.cu``, ``tp_cell_fwd.cu``,
``tp_cell_bwd.cu``) are written against every rank's buffer bases and the
ranks a launch runs (``csrc/tp_exchange.cuh``): in the one-card form one
launch runs all P ranks on one card; in this form each card runs one rank
(``rank0 = r``, ``n_local = 1``) and stores into its peers' buffers on their
cards over NVLink. What that needs of the host, shared by the collectives
and both cell kernels:

- peer access between every ordered pair of cards (:func:`enable_peers`,
  through the C entry ``sparch_tp_enable_peer``); a pair without it raises
  :class:`PeerAccessError`, and nothing falls back to the one-card form;
- every card's slots and counters, on that card, and the arrays of their
  bases in rank order (:class:`Exchange`). One set is kept for each kind,
  cards and type, at the largest size asked for so far; a call of a
  smaller shape uses its front (and zeroes all of it). A peer may store
  into a card's buffers until its own launch ends, which the caching
  allocator of that card cannot see: a set that is outgrown is freed only
  after its allocation streams wait on every card's last launch on it
  (:meth:`Exchange.retire`);
- one plan that every card agrees on (:func:`agreed_plan`): the ranks walk
  their row groups in one order (the deadlock rule of ``tp_exchange.cuh``),
  so a plan computed per card that differs raises :class:`PlanDisagreement`;
- the entry barrier, by CUDA events, so that a graph may hold it: card r's
  stream waits on every card's previous launch on the same buffers, zeroes
  its counters (and the slot of the column-slice forward), records Z_r, and
  every card's stream waits on every Z_q before its launch
  (:meth:`Exchange.enter`). Every card's launch is issued before the host
  waits on any of them.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["PeerAccessError", "PlanDisagreement", "enable_peers",
           "agreed_plan", "Exchange", "exchange", "gather_columns",
           "columns"]


class PeerAccessError(RuntimeError):
    """Two cards of a mesh cannot reach each other's memory."""


class PlanDisagreement(RuntimeError):
    """The cards of a mesh computed different launch plans."""


_ENABLED = set()  # (card, peer) pairs with peer access


def _enable_peer(card: int, peer: int) -> None:
    """``cudaDeviceEnablePeerAccess`` from ``card`` to ``peer`` (already
    enabled counts as done)."""
    from sparch_tpu_torch import _build

    fn = _build.load("tp_collectives").sparch_tp_enable_peer
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    with torch.cuda.device(card):
        err = fn(card, peer)
    if err:
        raise PeerAccessError(f"cudaDeviceEnablePeerAccess from cuda:{card} "
                              f"to cuda:{peer} failed: cudaError_t {err}")


def enable_peers(cards: Sequence[torch.device]) -> None:
    """Check and enable peer access between every ordered pair of
    ``cards``, once a pair a process; raises :class:`PeerAccessError` where
    a pair has none."""
    idx = [torch.device(c).index for c in cards]
    for a in idx:
        for b in idx:
            if a == b or (a, b) in _ENABLED:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise PeerAccessError(
                    f"cuda:{a} cannot access cuda:{b}'s memory "
                    f"(torch.cuda.can_device_access_peer): the TP ranks "
                    f"across cards store into their peers' buffers")
            _enable_peer(a, b)
            _ENABLED.add((a, b))


def agreed_plan(cards: Sequence[torch.device],
                plan_of: Callable[[torch.device], object]):
    """``plan_of(card)`` for every card; raises :class:`PlanDisagreement`
    unless they are all equal."""
    plans = [plan_of(c) for c in cards]
    if any(p != plans[0] for p in plans[1:]):
        raise PlanDisagreement(
            "the cards' launch plans differ; the ranks must walk their row "
            "groups alike: " + "; ".join(f"{c}: {p}"
                                        for c, p in zip(cards, plans)))
    return plans[0]


def columns(t: torch.Tensor, P: int, r: int) -> torch.Tensor:
    """Rank r's block of the last dimension of ``t`` over P ranks."""
    w = t.shape[-1] // P
    return t[..., r * w:(r + 1) * w]


def gather_columns(blocks: Sequence[torch.Tensor],
                   home: torch.device) -> torch.Tensor:
    """The ranks' blocks side by side on ``home``."""
    return torch.cat([b.to(home) for b in blocks], dim=-1)


class Exchange:
    """Every card's slots (``slot_words`` of ``dtype``, flat) and counters
    (``flag_words`` int32, none at 0) for one kind of launch, with the host
    arrays of their bases in rank order that the kernels take, and each
    card's event after its last launch on them. A launch of a smaller
    shape uses their front (:func:`exchange`)."""

    def __init__(self, cards: Sequence[torch.device], slot_words: int,
                 dtype: torch.dtype, flag_words: int):
        self.cards = tuple(torch.device(c) for c in cards)
        P = len(self.cards)
        self.slot_words, self.flag_words = slot_words, flag_words
        self.streams = [torch.cuda.current_stream(c) for c in self.cards]
        self.slots = [torch.empty(slot_words, dtype=dtype, device=c)
                      for c in self.cards]
        self.flags = [torch.zeros(flag_words, dtype=torch.int32, device=c)
                      for c in self.cards] if flag_words else []
        self._slot_arr = (ctypes.c_void_p * P)(
            *[s.data_ptr() for s in self.slots])
        self._flag_arr = (ctypes.c_void_p * P)(
            *[f.data_ptr() for f in self.flags]) if self.flags else None
        self.last: List[Optional[torch.cuda.Event]] = [None] * P
        self.capturing = False

    def holds(self, slot_words: int, flag_words: int) -> bool:
        return (slot_words <= self.slot_words
                and flag_words <= self.flag_words)

    def retire(self) -> None:
        """Before the set is dropped: each card's allocation stream waits on
        every card's last launch on it, so that the caching allocator hands
        its memory out again only behind the peers' stores."""
        for card, stream in zip(self.cards, self.streams):
            with torch.cuda.device(card):
                for ev in self.last:
                    if ev is not None:
                        stream.wait_event(ev)

    @property
    def slot_ptrs(self):
        return ctypes.cast(self._slot_arr, ctypes.c_void_p)

    @property
    def flag_ptrs(self):
        return (ctypes.cast(self._flag_arr, ctypes.c_void_p)
                if self._flag_arr is not None else None)

    def enter(self, zero_slots: bool = False) -> List[torch.cuda.Stream]:
        """The entry barrier (module docstring) on every card's current
        stream; returns those streams for :meth:`leave`. Under a CUDA graph
        capture the waits on launches outside it are left out (the graph
        orders its own launches by the zeroing events; the host orders
        replays against eager calls)."""
        streams = [torch.cuda.current_stream(c) for c in self.cards]
        self.capturing = _capturing(self.cards)
        zeroed = []
        for r, (card, stream) in enumerate(zip(self.cards, streams)):
            with torch.cuda.device(card):
                for ev in self.last:
                    if ev is not None and not self.capturing:
                        stream.wait_event(ev)
                if self.flags:
                    self.flags[r].zero_()
                if zero_slots:
                    self.slots[r].zero_()
                z = torch.cuda.Event()
                z.record(stream)
                zeroed.append(z)
        for card, stream in zip(self.cards, streams):
            with torch.cuda.device(card):
                for z in zeroed:
                    stream.wait_event(z)
        return streams

    def leave(self, streams: Sequence[torch.cuda.Stream]) -> None:
        """Each card's event after its launch, for the next entry (not
        under a capture)."""
        if self.capturing:
            return
        for r, (card, stream) in enumerate(zip(self.cards, streams)):
            with torch.cuda.device(card):
                ev = torch.cuda.Event()
                ev.record(stream)
                self.last[r] = ev


_EXCHANGES: Dict[Tuple, Exchange] = {}


def exchange(kind: str, cards: Sequence[torch.device], slot_shape,
             dtype: torch.dtype, flag_words: int) -> Exchange:
    """The :class:`Exchange` of ``kind`` over ``cards`` in ``dtype`` that
    holds ``slot_shape``'s words and ``flag_words`` counters: the one kept,
    or, where it is too small (or none is kept), a new one at the larger of
    the two sizes, the old one retired. Not inside a CUDA graph capture,
    which must find its set made by an eager call of its shape or a larger
    one."""
    key = (kind, tuple(torch.device(c) for c in cards), dtype)
    words = 1
    for n in slot_shape:
        words *= int(n)
    ex = _EXCHANGES.get(key)
    if ex is None or not ex.holds(words, flag_words):
        if _capturing(key[1]):
            raise RuntimeError(
                f"{kind} across cards: the first call at this size is "
                "inside a CUDA graph capture; make one eager call first")
        if ex is not None:
            ex.retire()
            words = max(words, ex.slot_words)
            flag_words = max(flag_words, ex.flag_words)
        ex = _EXCHANGES[key] = Exchange(key[1], words, dtype, flag_words)
    return ex


def _capturing(cards: Sequence[torch.device]) -> bool:
    """Whether any card's current stream is capturing a CUDA graph."""
    for card in cards:
        with torch.cuda.device(card):
            if torch.cuda.is_current_stream_capturing():
                return True
    return False
