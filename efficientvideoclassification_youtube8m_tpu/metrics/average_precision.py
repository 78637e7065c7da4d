"""Streaming (global) average-precision accumulator.

Numerically equivalent to
`/root/reference/code_student_uniform/average_precision_calculator.py`:
a bounded min-heap of (prediction, label) pairs plus non-interpolated
AP@n with the reference's seeded-shuffle tie-break (`_shuffle`,
`average_precision_calculator.py:234-240`) — the shuffle affects tie
ordering and therefore exact GAP parity, so it is reproduced verbatim
in behavior (random.seed(0) + random.sample).

Host-throughput design (the host aggregation must keep up with the
device eval step from one core): the heap lives in parallel float64
numpy arrays and `accumulate` pushes WHOLE BATCHES through a C kernel
replaying CPython heapq's exact layout (data/native/heap.cc), and the
AP sweep is vectorized with a cumulative sum whose left-to-right
accumulation order — including the no-op `+ 0.0` at negative ranks —
reproduces the reference loop bit-for-bit. A pure-Python heapq fallback
keeps identical behavior when the native library is unavailable.
"""

from __future__ import annotations

import heapq
import numbers
import random
from typing import Optional

import numpy as np


_NATIVE_CACHE = [False, None]  # (resolved?, module-or-None)
_PERM_VALIDATED = [None]  # lazily: does the C permutation match CPython?


def _native_perm_ok(native) -> bool:
    """One-time self-check: the C MT19937 sample replay must reproduce
    THIS interpreter's `random.sample` exactly; any divergence (e.g. a
    future CPython algorithm change) silently falls back to Python."""
    if _PERM_VALIDATED[0] is None:
        ok = True
        for n in (0, 1, 2, 7, 33, 1000):
            # a PRIVATE Random(0): same MT19937 stream as seed(0) on the
            # global instance, without perturbing the process-global RNG
            # (the module's own no-side-effect contract, see _shuffle)
            if (random.Random(0).sample(range(n), n)
                    != list(native.sample_perm(n))):
                ok = False
                break
        _PERM_VALIDATED[0] = ok
    return _PERM_VALIDATED[0]


def _native():
    if not _NATIVE_CACHE[0]:
        mod = None
        try:
            from efficientvideoclassification_youtube8m_tpu.data import native

            if native.available():
                mod = native
        except ImportError:
            pass
        _NATIVE_CACHE[:] = [True, mod]
    return _NATIVE_CACHE[1]


class AveragePrecisionCalculator:
    """Accumulates a ranked list (optionally top-n bounded) and computes
    non-interpolated average precision over it."""

    def __init__(self, top_n: Optional[int] = None):
        if not ((isinstance(top_n, int) and top_n >= 0) or top_n is None):
            raise ValueError("top_n must be a positive integer or None.")
        self._top_n = top_n
        self._total_positives = 0
        self._n = 0
        cap = 32 if top_n is None else min(max(top_n, 1), 32)
        self._pred_heap = np.empty(cap, np.float64)
        self._act_heap = np.empty(cap, np.float64)

    @property
    def heap_size(self) -> int:
        return self._n

    @property
    def _heap(self):
        """(prediction, actual) pairs in heap-array order — kept for
        introspection/test compatibility with the list-of-tuples heap."""
        return list(zip(self._pred_heap[: self._n], self._act_heap[: self._n]))

    @property
    def num_accumulated_positives(self):
        return self._total_positives

    def _reserve(self, extra: int):
        need = self._n + extra
        if self._top_n is not None:
            need = min(need, max(self._top_n, 1))
        if need > self._pred_heap.size:
            cap = max(need, 2 * self._pred_heap.size)
            for name in ("_pred_heap", "_act_heap"):
                old = getattr(self, name)
                new = np.empty(cap, np.float64)
                new[: self._n] = old[: self._n]
                setattr(self, name, new)

    def _adopt_heap(self, preds: np.ndarray, acts: np.ndarray, num_positives):
        """Take ownership of parallel arrays ALREADY in heapq layout (the
        segmented bulk build, heap.cc) — only valid on an empty unbounded
        calculator. The arrays may be views; any later accumulate grows
        into a fresh copy first (_reserve), so aliased neighbors are
        never written."""
        assert self._n == 0 and self._top_n is None
        self._pred_heap = preds
        self._act_heap = acts
        self._n = preds.size
        self._total_positives += num_positives

    def accumulate(self, predictions, actuals, num_positives=None):
        """Add a chunk of the ranked list. `num_positives` overrides
        positive counting when the chunk is already top-k truncated."""
        preds = np.ascontiguousarray(predictions, np.float64).ravel()
        acts = np.ascontiguousarray(actuals, np.float64).ravel()
        if preds.size != acts.size:
            raise ValueError("the shape of predictions and actuals does not match.")
        if num_positives is not None:
            if not isinstance(num_positives, numbers.Number) or num_positives < 0:
                raise ValueError(
                    "'num_positives' was provided but it was not a nonnegative number."
                )
            self._total_positives += num_positives
        else:
            self._total_positives += int(np.count_nonzero(acts > 0))

        if preds.size == 0:
            return
        self._reserve(preds.size)
        native = _native()
        top_n = -1 if self._top_n is None else self._top_n
        if native is not None:
            self._n = native.heap_push(
                self._pred_heap, self._act_heap, self._n, top_n, preds, acts
            )
        else:
            self._push_python(preds, acts)

    def _push_python(self, preds: np.ndarray, acts: np.ndarray):
        """heapq fallback — identical layout to the C kernel."""
        heap = list(
            zip(self._pred_heap[: self._n].tolist(),
                self._act_heap[: self._n].tolist())
        )
        topk = self._top_n
        for p, a in zip(preds.tolist(), acts.tolist()):
            if topk is None or len(heap) < topk:
                heapq.heappush(heap, (p, a))
            elif topk > 0 and p > heap[0][0]:
                heapq.heapreplace(heap, (p, a))
        self._n = len(heap)
        if heap:
            self._pred_heap[: self._n] = [p for p, _ in heap]
            self._act_heap[: self._n] = [a for _, a in heap]

    def clear(self):
        self._n = 0
        self._total_positives = 0

    def peek_ap_at_n(self) -> float:
        if self._n <= 0:
            return 0
        native = _native()
        if (native is not None and _native_perm_ok(native)
                and (self._top_n is None or self._top_n > 0)):
            # one C call: shuffle + stable sort + sweep (bit-identical
            # to ap_at_n; see heap.cc:ap_sweep_segments)
            return float(native.ap_sweep(
                np.ascontiguousarray(self._pred_heap[: self._n]),
                np.ascontiguousarray(self._act_heap[: self._n]),
                np.zeros(1, np.int64),
                np.asarray([self._n], np.int64),
                np.asarray([float(self._total_positives)], np.float64),
                -1 if self._top_n is None else self._top_n,
            )[0])
        return self.ap_at_n(
            self._pred_heap[: self._n],
            self._act_heap[: self._n],
            n=self._top_n,
            total_num_positives=self._total_positives,
        )

    @staticmethod
    def ap(predictions, actuals) -> float:
        return AveragePrecisionCalculator.ap_at_n(predictions, actuals, n=None)

    @staticmethod
    def ap_at_n(predictions, actuals, n=20, total_num_positives=None) -> float:
        if len(predictions) != len(actuals):
            raise ValueError("the shape of predictions and actuals does not match.")
        if n is not None and (not isinstance(n, int) or n <= 0):
            raise ValueError(f"n must be 'None' or a positive integer. It was {n!r}.")

        predictions = np.asarray(predictions)
        actuals = np.asarray(actuals)
        predictions, actuals = AveragePrecisionCalculator._shuffle(
            predictions, actuals
        )
        # stable descending sort AFTER the seeded shuffle == the
        # reference's `sorted(..., reverse=True)` tie behavior (stable
        # ascending argsort on the negated scores: equal scores keep
        # their shuffled order either way)
        sortidx = np.argsort(-predictions.astype(np.float64), kind="stable")

        if total_num_positives is None:
            numpos = np.size(np.where(actuals > 0))
        else:
            numpos = total_num_positives
        if numpos == 0:
            return 0
        if n is not None:
            numpos = min(numpos, n)
        delta_recall = 1.0 / numpos

        r = len(sortidx) if n is None else min(len(sortidx), n)
        pos = actuals[sortidx[:r]] > 0
        # The reference sweeps the ranked list accumulating
        # poscount/(i+1)*delta_recall at each positive
        # (average_precision_calculator.py:211-216). cumsum is the same
        # left-to-right accumulation, and the zero terms it adds at
        # negative ranks leave every partial sum bit-identical
        # (x + 0.0 == x), so this matches the loop exactly.
        if not pos.any():
            return 0.0
        poscount = np.cumsum(pos.astype(np.float64))
        ranks = np.arange(1, r + 1, dtype=np.float64)
        terms = np.where(pos, poscount / ranks * delta_recall, 0.0)
        return float(np.cumsum(terms)[-1])

    @staticmethod
    def _shuffle(predictions, actuals):
        n = len(predictions)
        native = _native()
        if native is not None and _native_perm_ok(native):
            # CPython-exact MT19937 replay in C (data/native/heap.cc):
            # the same permutation random.sample would draw, minus the
            # Python-speed cost on million-entry epoch pools.
            suffidx = native.sample_perm(n)
        else:
            # A PRIVATE Random(0) draws the exact same MT19937 stream as
            # the reference's `random.seed(0); random.sample(...)`
            # (average_precision_calculator.py:181-183) without mutating
            # the process-global RNG — so the native and fallback paths
            # have identical side effects (none) and identical output.
            suffidx = random.Random(0).sample(range(n), n)
        return predictions[suffidx], actuals[suffidx]

    @staticmethod
    def _zero_one_normalize(predictions, epsilon=1e-7):
        denominator = np.max(predictions) - np.min(predictions)
        return (predictions - np.min(predictions)) / max(denominator, epsilon)
