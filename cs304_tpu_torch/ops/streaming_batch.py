"""Batched live-stream serving: B concurrent online decodes per step.

ops/streaming.py decodes ONE live stream; a serving deployment has many
concurrent microphones at different points in their utterances. This module
advances all fed slots chunk-synchronously, one trellis launch per step:

- device-resident state: the (B, S) alpha carry plus a (B, T_max, S)
  backpointer ring (int8 when S <= 127, int32 otherwise), both updated in
  place;
- staggered starts: each slot carries its own absolute frame clock; a slot
  whose clock is 0 is (re)seeded from its first frame inside the step, so
  recycling a slot never needs a state write;
- per-step fill levels: the host mirrors each slot's frame count exactly
  (it supplies the valid counts), so ``fill()`` is free;
- finalize: best state (any state for partials, best exit for finals), K2-bt
  walking the ring in place, and word compaction, for every slot at once;
  the host reads back only scores and word ids.

The step on the card: ``step_impl="banded"`` is ONE launch of the stream
mode of the scan-free team kernel (ops/cuda/trellis_stream.py:
stream_advance), for the dense upload and the compact (sparse) upload
alike; ``step_impl="dense"`` (the JAX package's choice at <= 127 states)
is K4 (ops/cuda/trellis_dense.py) through dense_stream_advance's gather and
scatter. The plain step functions below (_advance, _advance_banded,
_advance_compact: torch versions of the JAX package's lax.scan steps) are
the kernels' plain versions; on a CPU tensor the wrappers run them, and on
the card the pool never calls them.

The JAX package's asynchronous readback of the step-fused partials is a
non-blocking copy into pinned host buffers followed by a CUDA event here.

With mesh= (parallel/data_parallel.make_mesh) the slots shard over the ranks
as P("data") shards the JAX pool's: rank r holds alpha and the ring of the
contiguous block [r n/w, (r+1) n/w) only and steps it. The host mirror
(clocks, free list, stream ids) is replicated: every rank makes the same
calls with the same feeds (SPMD). A finalize runs on each rank's block and
gathers the results, so each slot's answer comes from the rank that owns it.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device, upload, upload_ints
from .viterbi import (
    NEG,
    composite_transition_matrix,
    entry_update,
    first_max,
    lm_tables,
    pack_coefs,
)
from .words import ids_to_strings, words_from_paths

logger = logging.getLogger(__name__)

__all__ = ["BatchedStreamingComposite", "ring_dtype"]

def ring_dtype(num_states: int) -> torch.dtype:
    """Backpointer storage dtype: state indices (+ the -1 seed sentinel)."""
    return torch.int8 if num_states <= 127 else torch.int32


def _banded_coeffs(log_a, lower_of_state, is_entry, is_exit, penalty,
                   pair_penalty=None, word_of_state=None, uppers=None,
                   device=None):
    """Per-state banded coefficients of the composite step, as the JAX
    package's tuple (sub1, sub2, diag_ne, diag_e, is_exit, penalty, lm):
    pack_coefs' rows 1, 2, 0, 3 and 5; lm is None, or for a pair penalty
    (W, W) (a bigram LM, ops/lm.word_pair_penalties) lm_tables' (pair,
    word_of_state, uppers)."""
    lm = (lm_tables(pair_penalty, word_of_state, uppers, device=device)
          if pair_penalty is not None else None)
    return _coeffs_of(pack_coefs(log_a, lower_of_state, is_entry, is_exit,
                                 device=device), penalty, lm)


def _coeffs_of(coefs, penalty, lm=None):
    """_banded_coeffs' tuple from pack_coefs rows (8, S) and lm_tables'."""
    return (coefs[1], coefs[2], coefs[0], coefs[3], coefs[5] > 0,
            torch.as_tensor(penalty, dtype=torch.float32, device=coefs.device), lm)


def _banded_step(rows, is_entry, coeffs):
    """One banded composite step over (K, S) rows -> (value before the
    emission, backpointers int64): skip-2, skip-1, self on >=; an entry takes
    the best exit + penalty against its self-loop (with an LM, the per-word
    best over source words, ops/viterbi.entry_update), the exit winning a
    tie. The plain version of the stream mode and its LM variant."""
    sub1, sub2, diag_ne, diag_e, is_exit, penalty, lm = coeffs
    s = rows.shape[1]
    to = torch.arange(s, device=rows.device)
    a1 = torch.full_like(rows, NEG)
    a1[:, 1:] = rows[:, :-1]
    a2 = torch.full_like(rows, NEG)
    a2[:, 2:] = rows[:, :-2]
    c0 = rows + diag_ne
    c1 = a1 + sub1
    c2 = a2 + sub2
    v12 = torch.maximum(c1, c0)
    val_ne = torch.maximum(c2, v12)
    bp_ne = torch.where(c2 >= v12, (to - 2).clamp(min=0),
                        torch.where(c1 >= c0, (to - 1).clamp(min=0), to))
    c_pen, best_exit_idx = entry_update(rows, is_exit, penalty, *(lm or ()))
    c_self = rows + diag_e
    val_e = torch.maximum(c_pen, c_self)
    bp_e = torch.where(c_pen >= c_self, best_exit_idx, to)
    return torch.where(is_entry, val_e, val_ne), torch.where(is_entry, bp_e, bp_ne)


def _advance_compact(alpha, ring, slot_ids, t, valid, log_b, seed_bias,
                     is_entry, trans=None, coeffs=None):
    """The pool step over K fed rows: alpha (B, S) float32 and ring
    (B, T_max, S) are updated IN PLACE and returned; slot_ids (K,) names each
    row's slot (a padding row carries B and valid 0), t/valid (K,) are the
    rows' clocks and frame counts, log_b (K, C, >=S). Frame i of row k is
    live when i < valid[k]; an absolute frame 0 seeds the row (entry states,
    backpointer -1); each live frame's backpointers go to
    ring[slot, clip(t + i)]. trans (S, S) selects the dense step (first-max
    argmax), coeffs (_banded_coeffs) the banded one. Idle slots are untouched
    by construction: their ids never appear."""
    b, t_max, s = ring.shape
    c = log_b.shape[1]
    dev = alpha.device
    slot_ids = torch.as_tensor(slot_ids, device=dev).to(torch.int64)
    t = torch.as_tensor(t, device=dev).to(torch.int64)
    valid = torch.as_tensor(valid, device=dev).to(torch.int64)
    in_pool = slot_ids < b
    rows = torch.where(in_pool[:, None], alpha[torch.where(in_pool, slot_ids, 0)], NEG)
    for i in range(c):
        log_b_i = log_b[:, i, :s]
        live = i < valid
        abs_t = t + i
        if trans is not None:
            val, bp = torch.max(rows[:, :, None] + trans[None], dim=1)
        else:
            val, bp = _banded_step(rows, is_entry, coeffs)
        new_rows = val + log_b_i
        seed = torch.where(is_entry, log_b_i + seed_bias, NEG)
        is_seed = (abs_t == 0)[:, None]
        new_rows = torch.where(is_seed, seed, new_rows)
        bp = torch.where(is_seed, -1, bp).to(ring.dtype)
        rows = torch.where(live[:, None], new_rows, rows)
        w = live & in_pool
        ring[slot_ids[w], abs_t[w].clamp(0, t_max - 1)] = bp[w]
    keep = (valid > 0) & in_pool
    alpha[slot_ids[keep]] = rows[keep]
    return alpha, ring


def _advance(alpha, ring, t, valid, log_b, trans, seed_alpha_bias, is_entry):
    """The dense step over every slot: alpha (B, S), ring (B, T_max, S),
    t/valid (B,), log_b (B, C, S) -> (alpha, ring, t + valid), alpha and ring
    updated in place."""
    slots = torch.arange(ring.shape[0], device=alpha.device)
    _advance_compact(alpha, ring, slots, t, valid, log_b, seed_alpha_bias,
                     is_entry, trans=trans)
    return alpha, ring, torch.as_tensor(t, device=alpha.device) + torch.as_tensor(
        valid, device=alpha.device)


def _advance_banded(alpha, ring, t, valid, log_b, coeffs, seed_alpha_bias,
                    is_entry):
    """The banded twin of _advance (same carry and ring contract, O(S))."""
    slots = torch.arange(ring.shape[0], device=alpha.device)
    _advance_compact(alpha, ring, slots, t, valid, log_b, seed_alpha_bias,
                     is_entry, coeffs=coeffs)
    return alpha, ring, torch.as_tensor(t, device=alpha.device) + torch.as_tensor(
        valid, device=alpha.device)


def _finalize_batch(alpha, ring, t, is_exit, word_of_state, lowers, uppers,
                    silence_word, any_state: bool, max_words: int):
    """alpha (B, S), ring (B, T, S) (a slice of the pool's ring), t (B,)
    int32 fills -> (scores (B,), word ids (B, max_words), counts (B,)): the
    first max over all states (any_state) or the exits, the walk of the ring
    without the reference quirk (K2-bt on the card), word compaction."""
    from .cuda.trellis_scanfree import trellis_backtrace

    mask = torch.ones_like(is_exit) if any_state else is_exit
    scores, best = first_max(alpha, mask)
    paths = trellis_backtrace(ring, best, t, quirk=False)
    ids, counts = words_from_paths(paths, t, word_of_state, lowers, uppers,
                                   silence_word, max_words=max_words)
    return scores, ids, counts


class BatchedStreamingComposite:
    """B-slot chunk-synchronous online decoding over a CompositeHMM.

    >>> pool = BatchedStreamingComposite(composite, num_slots=64)
    >>> a, b = pool.start(), pool.start()
    >>> pool.step({a: chunk_a0, b: chunk_b0})   # ONE trellis launch
    >>> pool.step({a: chunk_a1})                # b idles this step
    >>> score, text = pool.finalize([a])[a]
    >>> pool.release(a)                         # slot recycled for a new mic
    """

    def __init__(self, composite, num_slots: int = 64, chunk_size: int = 16,
                 max_frames: int = 2048, gmm_params=None,
                 max_words: int = 64, mesh=None,
                 step_impl: str = "auto", bigram=None,
                 lm_weight: float = 1.0, emissions: str = "whiten",
                 sparse_upload: bool | str = "auto", device=None) -> None:
        """step_impl: "dense" (the (S', S) max-plus step, K4 on the card),
        "banded" (the O(S) step, the stream mode of the scan-free team kernel
        on the card), or "auto" (banded past 127 states, as in the JAX
        package). emissions: "whiten" (f32-exact) or "quad" (the emission
        kernel on the card; Gaussian banded step only: GMMs have no quad
        form here). gmm_params: optional ops.gaussian.GMMParams over the
        composite's states, on ``device``: K-mixture whitening emissions
        before the same dense or banded step (from_models builds them for
        GMM or mixed model lists). sparse_upload: the compact upload of only
        the fed slots; "auto" picks it per step when the padded fed set is at
        most half the slots. device: None means the card (raising without
        one); tests pass "cpu".

        bigram (+ lm_weight): decode online under the bigram LM's per-pair
        inter-word penalties (ops/lm.word_pair_penalties), the measure of
        ContinuousDecoder(bigram=...), so finals equal its results. Forces
        the banded step, as in the JAX package: on the card the LM variant
        of the stream mode (ops/cuda/trellis_stream.stream_advance_lm).

        mesh: optional data-parallel mesh (parallel/data_parallel.make_mesh)
        over which the slots shard; num_slots must divide over the ranks.
        The pool then runs on the rank's mesh device, which an explicit
        device= must name. sparse_upload=True is refused over a mesh (its
        compact rows index the whole pool); "auto" keeps the dense upload
        of each rank's block."""
        self.num_slots = int(num_slots)
        self.mesh = mesh
        self._lo, self._hi = 0, self.num_slots  # this rank's block of slots
        if mesh is not None:
            from ..parallel.data_parallel import mesh_rank, mesh_size, site_device

            self.device = site_device(mesh, device)
            w = mesh_size(mesh)
            if self.num_slots % w:
                raise ValueError(f"num_slots={self.num_slots} must divide evenly over the "
                                 f"{w}-rank mesh")
            if sparse_upload is True:
                raise ValueError(
                    "sparse_upload uses pool-wide slot indices — not implemented over "
                    "a mesh (slots are already partitioned); use sparse_upload='auto'")
            block = self.num_slots // w
            self._lo = mesh_rank(mesh) * block
            self._hi = self._lo + block
        else:
            self.device = resolve_device(device)
        self.composite = composite
        self.chunk_size = int(chunk_size)
        self.max_frames = int(max_frames)
        self.max_words = int(max_words)
        c, dev = composite, self.device
        s = c.num_states
        if step_impl not in ("auto", "dense", "banded"):
            raise ValueError(f"unknown step_impl {step_impl!r}")
        if bigram is not None:
            if step_impl == "dense":
                logger.info("bigram LM streaming uses the banded step")
            step_impl = "banded"
        elif step_impl == "auto":
            step_impl = "banded" if s > 127 else "dense"
        self.step_impl = step_impl
        self._coefs = pack_coefs(c.log_a, c.lower_of_state, c.is_entry, c.is_exit,
                                 device=dev)
        self._lm = None
        if bigram is not None:
            from .lm import word_pair_penalties

            self._lm = lm_tables(word_pair_penalties(c, bigram, lm_weight),
                                 c.word_of_state, c.uppers, device=dev)
        self._trans = (composite_transition_matrix(
            c.log_a, c.lower_of_state, c.is_entry, c.is_exit, c.penalty, device=dev)
            if step_impl == "dense" else None)
        self._is_exit = self._coefs[5] > 0
        if emissions not in ("whiten", "quad"):
            raise ValueError(f"unknown emissions layout {emissions!r}")
        if emissions == "quad" and (gmm_params is not None or step_impl == "dense"):
            raise ValueError("emissions='quad' needs the Gaussian banded step")
        self.emissions = emissions
        from .gaussian import make_gaussian_params, make_gaussian_quad_params

        self._gmm_params = gmm_params
        if gmm_params is not None:
            self._emission = None
        elif emissions == "quad":
            self._emission = make_gaussian_quad_params(c.means, c.covariances, device=dev)
        else:
            self._emission = make_gaussian_params(c.means, c.covariances, device=dev)
        self._lowers = torch.as_tensor(c.lowers, dtype=torch.int32, device=dev)
        self._uppers = torch.as_tensor(c.uppers, dtype=torch.int32, device=dev)
        local = self._hi - self._lo
        self._alpha = torch.full((local, s), NEG, dtype=torch.float32, device=dev)
        self._ring = torch.full((local, self.max_frames, s), -1,
                                dtype=ring_dtype(s), device=dev)
        self._t = np.zeros(self.num_slots, np.int32)  # exact host mirror
        self._free: List[int] = list(range(self.num_slots))[::-1]
        self._active: set[int] = set()
        # Step-fused partials: step(partials=True) runs the any-state
        # finalize in the same round and starts a non-blocking copy of the
        # word ids into pinned host memory; a later partial_texts() poll
        # reads it after its event. Stream ids guard against a released and
        # reused slot reading its predecessor's text.
        self._stream_id = np.zeros(self.num_slots, np.int64)
        self._pending: Optional[dict] = None
        self._pending_prev: Optional[dict] = None
        self._dim = c.means.shape[-1]
        if sparse_upload not in (True, False, "auto"):
            raise ValueError(f"unknown sparse_upload {sparse_upload!r}")
        self._sparse = sparse_upload is True or (sparse_upload == "auto" and mesh is None)
        # "auto" picks PER STEP: the compact path only when the fed set is
        # genuinely sparse; sparse_upload=True forces it.
        self._sparse_forced = sparse_upload is True

    @classmethod
    def from_models(cls, models, penalty: float = -100.0, **kwargs
                    ) -> "BatchedStreamingComposite":
        """Constructor from a model dict/list (sorted by label, as the
        decoder stacks them), GMM-aware: K-mixture models stream with their
        GMM densities (the decoder's lift, models/decoder.py:_lift_to_gmm)."""
        from ..models.decoder import _lift_to_gmm
        from ..models.hmm import stack_word_models
        from .gaussian import make_gmm_params

        if isinstance(models, dict):
            models = list(models.values())
        models = sorted(models, key=lambda m: m.label)
        if any(getattr(m, "weights", None) is not None for m in models):
            from ..parallel.data_parallel import site_device

            views, (means, covs, weights) = _lift_to_gmm(models)
            device, mesh = kwargs.pop("device", None), kwargs.get("mesh")
            dev = site_device(mesh, device) if mesh is not None else resolve_device(device)
            return cls(stack_word_models(views, penalty),
                       gmm_params=make_gmm_params(means, covs, weights, device=dev),
                       device=dev, **kwargs)
        return cls(stack_word_models(models, penalty), **kwargs)

    # -- slot lifecycle -------------------------------------------------------
    def start(self) -> int:
        """Claim a free slot for a new stream; its first fed frame seeds it."""
        if not self._free:
            raise RuntimeError(
                f"all {self.num_slots} slots busy — release() one or build a "
                "bigger pool"
            )
        slot = self._free.pop()
        self._t[slot] = 0
        self._stream_id[slot] += 1
        self._active.add(slot)
        return slot

    def release(self, slot: int) -> None:
        """Return a slot to the free list (device rows overwritten on reuse)."""
        self._check_slot(slot)
        self._active.discard(slot)
        self._t[slot] = 0
        self._free.append(slot)

    def fill(self) -> Dict[int, int]:
        """Frames accumulated per active slot (host mirror — no device sync)."""
        return {slot: int(self._t[slot]) for slot in sorted(self._active)}

    def fill_of(self, slot: int) -> int:
        """One slot's accumulated frames (the serving ring-capacity guard)."""
        self._check_slot(slot)
        return int(self._t[slot])

    def _check_slot(self, slot: int) -> None:
        if slot not in self._active:
            raise KeyError(f"slot {slot} is not active")

    # -- streaming ------------------------------------------------------------
    def step(self, feeds: Dict[int, np.ndarray],
             partials: bool = False) -> None:
        """Advance fed slots by their chunks in one trellis launch.

        feeds: slot -> (c, D) float32 features, c <= chunk_size. Slots not in
        feeds idle (their state is untouched). An empty feeds dict is a no-op.
        partials=True also runs the any-state finalize for the whole pool
        and starts its non-blocking readback (see partial_texts)."""
        if not feeds:
            return
        checked = {}
        for slot, feats in feeds.items():
            self._check_slot(slot)
            feats = np.asarray(feats, np.float32)
            if feats.ndim != 2 or feats.shape[1] != self._dim:
                raise ValueError(
                    f"slot {slot}: expected (c, {self._dim}) features, got "
                    f"{feats.shape}"
                )
            c = feats.shape[0]
            if c > self.chunk_size:
                raise ValueError(
                    f"slot {slot}: chunk of {c} frames exceeds chunk_size="
                    f"{self.chunk_size} — split it across steps"
                )
            if self._t[slot] + c > self.max_frames:
                raise ValueError(
                    f"slot {slot}: {self._t[slot]} + {c} frames exceeds "
                    f"max_frames={self.max_frames} — finalize or enlarge the "
                    "ring"
                )
            checked[slot] = feats
        k_pad = max(8, 1 << (len(checked) - 1).bit_length())
        c_used = max(f.shape[0] for f in checked.values())
        # Both axes bucket to powers of two: a handful of shapes.
        c_pad = min(self.chunk_size, max(4, 1 << (int(c_used) - 1).bit_length()))
        if self._sparse and (self._sparse_forced or k_pad <= self.num_slots // 2):
            # Compact upload: only the fed slots' rows (padding rows carry
            # the out-of-range slot num_slots and valid 0).
            ids = sorted(checked)
            rows = k_pad
            slot_ids = np.full(k_pad, self.num_slots, np.int32)
            slot_ids[: len(ids)] = ids
        else:
            # The dense upload of this rank's block (the whole pool without
            # a mesh).
            ids = list(range(self._lo, self._hi))
            rows = len(ids)
            slot_ids = np.arange(rows, dtype=np.int32)
        feats = np.zeros((rows, c_pad, self._dim), np.float32)
        t_rows = np.zeros(rows, np.int32)
        valid_rows = np.zeros(rows, np.int32)
        for j, slot in enumerate(ids):
            t_rows[j] = self._t[slot]
            if slot in checked:
                f = checked[slot]
                feats[j, : f.shape[0]] = f
                valid_rows[j] = f.shape[0]
        self._advance_rows(slot_ids, t_rows, valid_rows, feats)
        for slot, f in checked.items():
            self._t[slot] += f.shape[0]
        if partials:
            self._dispatch_partials()

    def _log_b(self, feats: torch.Tensor) -> torch.Tensor:
        """(R, C, D) features -> (R, C, S) emissions."""
        from .gaussian import gaussian_log_pdf, gaussian_log_pdf_quad, gmm_log_pdf

        r, c, d = feats.shape
        flat = feats.reshape(r * c, d)
        if self._gmm_params is not None:
            log_b = gmm_log_pdf(self._gmm_params, flat)
        elif self.emissions == "quad":
            log_b = gaussian_log_pdf_quad(self._emission, flat)
        else:
            log_b = gaussian_log_pdf(self._emission, flat)
        return log_b.reshape(r, c, -1)

    def _advance_rows(self, slot_ids, t_rows, valid_rows, feats) -> None:
        """One pool step on host-built rows: emissions, then the trellis."""
        from .cuda.trellis_stream import (
            dense_stream_advance,
            stream_advance,
            stream_advance_lm,
        )

        dev = self.device
        log_b = self._log_b(upload(feats, dev))
        if self.step_impl == "banded":
            rows = upload_ints((slot_ids, t_rows, valid_rows), dev, np.int32)
            if self._lm is not None:
                stream_advance_lm(self._alpha, self._ring, *rows, log_b, self._coefs, self._lm)
            else:
                stream_advance(self._alpha, self._ring, *rows, log_b, self._coefs,
                               self.composite.penalty)
        else:
            dense_stream_advance(self._alpha, self._ring, slot_ids, t_rows,
                                 valid_rows, log_b, self._trans, self._coefs)

    def _dispatch_partials(self, skip_silence: bool = True) -> None:
        """Run the any-state finalize now and start its readback: on the card
        a non-blocking copy into fresh pinned buffers and an event that
        partial_texts() waits on. The snapshot records each slot's stream id
        and fill so a poll can prove per-slot freshness."""
        _scores, ids, counts = self._run_finalize(True, skip_silence)
        event = None
        if ids.is_cuda:
            host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in (ids, counts)]
            for h, x in zip(host, (ids, counts)):
                h.copy_(x, non_blocking=True)
            ids, counts = host
            event = torch.cuda.Event()
            event.record()
        # Keep ONE completed generation behind: the pipelined mode reads the
        # previous round's snapshot (its work done during this round's host
        # work) rather than wait for the queue it just grew.
        self._pending_prev = self._pending
        self._pending = {
            "ids": ids, "counts": counts, "event": event, "texts": None,
            "t": self._t.copy(), "sid": self._stream_id.copy(),
            "skip_silence": skip_silence,
        }

    # -- results --------------------------------------------------------------
    def _run_finalize(self, any_state: bool, skip_silence: bool):
        c = self.composite
        sil = (
            c.labels.index("S")
            if (skip_silence and "S" in c.labels) else -1
        )
        t_dev = upload(self._t[self._lo: self._hi], self.device)
        # Walk a 512-frame bucket over the deepest fill of the pool (in
        # place: K2-bt takes the ring's slot stride).
        t_bucket = min(
            self.max_frames,
            max(512, -(-int(self._t.max(initial=0)) // 512) * 512),
        )
        out = _finalize_batch(
            self._alpha, self._ring[:, :t_bucket], t_dev, self._is_exit,
            None, self._lowers, self._uppers, sil, any_state, self.max_words,
        )
        if self.mesh is None:
            return out
        from ..parallel.data_parallel import gather_rows

        return tuple(gather_rows(x, self.mesh) for x in out)

    def finalize(self, slots: Sequence[int],
                 skip_silence: bool = True) -> Dict[int, tuple]:
        """slot -> (score, text) with the offline termination (best exit).
        One pass for all requested slots; readback is scores + word ids
        only. Does not release the slots."""
        for slot in slots:
            self._check_slot(slot)
            if self._t[slot] == 0:
                raise ValueError(f"slot {slot} has no frames to finalize")
        scores, ids, counts = (x.cpu().numpy()
                               for x in self._run_finalize(False, skip_silence))
        texts = ids_to_strings(ids, counts, self.composite.labels)
        return {
            slot: (float(scores[slot]), texts[slot]) for slot in slots
        }

    def _materialize(self, p: dict) -> List[str]:
        if p["texts"] is None:
            if p["event"] is not None:
                p["event"].synchronize()  # this generation's copy only
            p["texts"] = ids_to_strings(
                p["ids"].numpy(), p["counts"].numpy(), self.composite.labels,
            )
        return p["texts"]

    def partial_texts(
        self, slots: Sequence[int] | None = None, skip_silence: bool = True,
        stale_ok: bool = False,
    ) -> Dict[int, str]:
        """Best hypotheses so far for many slots — ONE finalize and one
        readback regardless of how many slots are polled (any state may end
        a partial). Slots with no frames yet map to "".

        When the last step() ran with partials=True and no requested slot
        advanced since, the answer comes from that step's own readback.
        stale_ok=True also accepts the PREVIOUS fused snapshot — at most one
        step stale per slot, never crossing a stream boundary — so a poll
        right after a step waits only for the previous round's copy, never
        for the work it just queued (the pipelined serving mode)."""
        if slots is None:
            slots = sorted(self._active)
        for slot in slots:
            self._check_slot(slot)
        if not any(self._t[slot] > 0 for slot in slots):
            return {slot: "" for slot in slots}
        p = self._pending
        if (
            p is not None and p["skip_silence"] == skip_silence
            and all(
                self._t[s] == 0
                or (p["sid"][s] == self._stream_id[s]
                    and p["t"][s] == self._t[s])
                for s in slots
            )
        ):
            texts = self._materialize(p)
        elif stale_ok and p is not None:
            use = self._pending_prev
            if use is None or use["skip_silence"] != skip_silence:
                use = p
            texts = self._materialize(use)
            return {
                slot: (
                    texts[slot]
                    if (self._t[slot] > 0
                        and use["sid"][slot] == self._stream_id[slot]
                        and use["t"][slot] > 0)
                    else ""
                )
                for slot in slots
            }
        else:
            _scores, ids, counts = self._run_finalize(True, skip_silence)
            texts = ids_to_strings(ids.cpu().numpy(), counts.cpu().numpy(),
                                   self.composite.labels)
        return {
            slot: (texts[slot] if self._t[slot] > 0 else "")
            for slot in slots
        }

    def partial_text(self, slot: int, skip_silence: bool = True) -> str:
        """Best hypothesis so far for one slot. Polling many slots? Use
        partial_texts — this costs a full-pool finalize per call."""
        return self.partial_texts([slot], skip_silence)[slot]
