"""Continuous-batching serving engine.

Slot-based scheduler in the vLLM style: a fixed pool of B cache slots;
arriving requests are admitted into free slots by prefilling their prompt
one token at a time through the decode step (every slot is decoded, only
the admitted slot advances), every engine step decodes one token for all
active slots, finished requests free their slot immediately.

The engine runs where its parameters lie. The decode state lives on that
device and is updated IN PLACE: a decode step writes the new k/v and the
new recurrent states (Mamba2's conv/ssd, RWKV6's x_tm/x_cm/wkv) only for
the rows that advance, so every other row keeps its caches and its length
exactly. (The reference rebuilds the whole state by merging the advanced
rows into the old one; the result is the same.) The lengths are mirrored
on the host, where the scheduler reads them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..arch import model as M
from ..arch.params import tree_leaves
from ..configs.base import ModelConfig


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 16
    arrived_at: float = 0.0
    # filled by the engine:
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_seq: int = 256, eos_id: Optional[int] = None,
                 greedy: bool = True):
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.name} cannot decode")
        self.cfg = cfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.greedy = greedy
        self.state = M.init_decode_state(cfg, max_slots, max_seq,
                                         device=self.device)
        self.lengths = np.zeros(max_slots, np.int32)     # host mirror
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self._next_input: List[int] = [0] * max_slots
        self.queue: List[Request] = []
        self.steps = 0
        self.tokens_out = 0
        self.decode_calls = 0

    # ------------- request plumbing -------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self):
        """Prefill pending requests into free slots, token by token through
        the decode step, as the reference does."""
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            self._reset_slot(slot)
            for tok in req.prompt[:-1]:
                self._step_slot(slot, int(tok))
            self.slot_req[slot] = req
            req.tokens = []
            self._next_input[slot] = int(req.prompt[-1])

    def _reset_slot(self, slot: int):
        for leaf in tree_leaves(self.state["caches"]):
            leaf[:, slot].zero_()
        self.lengths[slot] = 0

    def _decode(self, toks: np.ndarray, rows: List[int]) -> torch.Tensor:
        """One decode step over every slot; only ``rows`` advance."""
        state = {"caches": self.state["caches"],
                 "lengths": torch.from_numpy(self.lengths).to(self.device)}
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        idx = torch.tensor(rows, dtype=torch.long, device=self.device)
        logits, _ = M.decode_step(self.cfg, self.params, state, batch,
                                  rows=idx)
        self.lengths[rows] += 1
        self.decode_calls += 1
        return logits

    def _step_slot(self, slot: int, token: int):
        """Advance ONE slot by one token (prefill path)."""
        toks = np.zeros((self.max_slots, 1), np.int64)
        toks[slot] = token
        return self._decode(toks, [slot])[slot]

    # ------------- main loop -------------
    def step(self, now: Optional[float] = None) -> int:
        """One engine iteration: admit + one decode for all active slots.
        Returns number of tokens emitted."""
        now = time.perf_counter() if now is None else now
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        toks = np.zeros((self.max_slots, 1), np.int64)
        for i in active:
            toks[i] = self._next_input[i]
        logits = self._decode(toks, active)
        if self.greedy:   # argmax on the card: the first maximum, as numpy's
            picks = torch.argmax(logits[active], dim=-1).tolist()
        else:
            host = logits[active].cpu().numpy()
            picks = [int(np.random.default_rng(self.steps).choice(
                len(row), p=_softmax(row))) for row in host]

        emitted = 0
        for i, nxt in zip(active, picks):
            req = self.slot_req[i]
            req.tokens.append(nxt)
            if req.first_token_at is None:
                req.first_token_at = now
            emitted += 1
            self.tokens_out += 1
            self._next_input[i] = nxt
            full = int(self.lengths[i]) >= self.max_seq - 1
            if (len(req.tokens) >= req.max_new_tokens or full
                    or (self.eos_id is not None and nxt == self.eos_id)):
                req.done = True
                req.finished_at = now
                self.slot_req[i] = None
        self.steps += 1
        return emitted

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        total = 0
        for _ in range(max_steps):
            got = self.step()
            if got == 0 and not self.queue:
                break
            total += got
        return total


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()
