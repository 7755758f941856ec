"""Query sampling and batch-Merkle proof planning on the device.

Counterpart of ``genstark_tpu/protocol/device_queries.py``.  The prover's
one-fetch tail (protocol/prover.py `_packed_tail`) derives the query
positions and every batch proof's fetch rows on the device, so a proof
needs one transfer at its end:

- `sample_sets`: every query set of a proof (the execution set and one per
  FRI layer, each seeded by a root) in one launch of kernel B
  (csrc/queries.cu); its plain version `sample_sets_ref` runs the JAX
  `sample_indexes_dev` (:53) in torch on hash/sha256.py's plain rounds,
  for every set at once.  Both equal
  protocol/queries.py's `get_pseudorandom_indexes` over the first n_cand
  candidates, the Node hex quirk included, and keep their indexes in int64
  (the JAX function's int32 wraps at 2^31 when max_ = 2^32).
  `sample_indexes_ref` is one set of it.
- `dedup_rows`, `augment_stark`, `augment_fri`: the insertion-ordered
  dedups (`_dedup_ordered` :162, `augment_stark` :179, `augment_fri` :188),
  every set at once.
- `plan_rows_batch`: merkle.plan_batch's fetch rows (`plan_rows_dev` :196)
  for every plan of a proof at once, one [plans, depth, C, C] comparison;
  `compact` packs the kept rows of many plans in order.

These stay plain torch on every device: a handful of launches over a few
million booleans a proof, with no Python loop over levels or plans.  Outputs
are padded to the caller's caps; the caller checks the fetched positions
against the host sampler and falls back to the host path on any
difference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from ..hash import sha256 as _sha256

_I64 = torch.int64
M32 = 0xFFFFFFFF


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit lengths of int64 values in [0, 2^32) (0 for 0), exactly: frexp
    of a float64 holding the value."""
    return torch.frexp(x.to(torch.float64))[1].to(_I64)


def sample_indexes_ref(seed_words: torch.Tensor, count: int, max_: int,
                       exclude_multiples_of: int, n_cand: int):
    """`get_pseudorandom_indexes(seed, count, max_, excl)` over candidates
    i < n_cand, vectorized (the JAX `sample_indexes_dev`): seed_words
    int32 [8] LE words of the 32-byte seed; max_ and excl powers of two
    (excl 0: none), max_ <= 2^32.  Returns (idx int64 [count] zero-padded,
    found int32 scalar tensor); found < count means the window ran out."""
    idx, found = sample_sets_ref(seed_words[None], [(count, max_, exclude_multiples_of, n_cand)])
    return idx[0], found[0]


def sample_sets_ref(roots: torch.Tensor, specs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B: the JAX `sample_indexes_dev`'s steps in
    torch, for S sets at once.  roots int32 [S, 8] (each set's seed), specs
    S tuples (count, max_, exclude_multiples_of, n_cand) -> (idx int64 [S,
    max count] zero-padded, found int32 [S])."""
    for _, max_, excl, _ in specs:
        assert max_ & (max_ - 1) == 0 and max_.bit_length() <= 33
        assert excl == 0 or excl & (excl - 1) == 0
    dev = roots.device
    S = len(specs)
    col = lambda values: torch.as_tensor(values, dtype=_I64, device=dev)[:, None]   # [S, 1]
    counts = col([c for c, _, _, _ in specs])
    n = max(spec[3] for spec in specs)
    cap = max(spec[0] for spec in specs)
    # state = sha256(seed) as 8 BE words [S, 1] each
    st = _sha256.byteswap32(_sha256.digest_rows_le((roots.to(_I64) & M32).T, 32))[:, :, None]

    # v_i = state + i as 9 BE words [S, n], v[0] the carry out of 2^256
    i = torch.arange(n, dtype=_I64, device=dev)[None]
    words, carry = [None] * 8, i
    for w in range(7, -1, -1):
        t = st[w] + carry
        words[w], carry = t & M32, t >> 32
    v = [carry] + words

    # k: v's hex digits (0 for v = 0); an odd k drops the last digit
    k = torch.zeros((S, n), dtype=_I64, device=dev)
    for w in range(8, -1, -1):
        digits = (8 - w) * 8 + ((_bit_length(v[w]) + 3) >> 2)
        k = torch.where(v[w] != 0, digits, k)
    odd = (k & 1) == 1
    shifted = [v[0] >> 4] + [(v[w] >> 4) | ((v[w - 1] << 28) & M32) for w in range(1, 9)]
    wv = [torch.where(odd, shifted[w], v[w]) for w in range(9)]
    ell = k >> 1                                                     # message bytes <= 32

    # message byte b <= ell is X[b + 36 - ell], X = wv's 36 BE bytes then
    # the 0x80 terminator
    X = torch.stack([(wv[b // 4] >> (8 * (3 - b % 4))) & 0xFF for b in range(36)]
                    + [torch.full_like(k, 0x80)])                    # [37, S, n]
    b_idx = torch.arange(34, device=dev)[:, None, None]
    M = torch.gather(X, 0, torch.clamp(b_idx + 36 - ell[None], 0, 36))
    M = torch.where(b_idx <= ell[None], M, torch.zeros_like(M))
    zero = torch.zeros_like(k)
    byte = lambda b: M[b] if b < 34 else zero
    block = [(byte(4 * j) << 24) | (byte(4 * j + 1) << 16) | (byte(4 * j + 2) << 8)
             | byte(4 * j + 3) for j in range(9)] + [zero] * 6 + [ell * 8]
    digest = _sha256.compress([torch.full_like(k, h) for h in _sha256.H0], block)
    cand = digest[7] & col([m - 1 for _, m, _, _ in specs])          # int64 [S, n]

    excl = col([x for _, _, x, _ in specs])
    valid = ((cand & (excl - 1)) != 0) | (excl == 0)
    valid &= i < col([c for _, _, _, c in specs])                  # each set's window
    # first-occurrence dedup: candidate i survives iff no valid j < i has
    # its index
    earlier = i[0][:, None] > i[0][None, :]
    dup = ((cand[:, None, :] == cand[:, :, None]) & earlier & valid[:, None, :]).any(-1)
    keep = valid & ~dup
    order = torch.cumsum(keep.to(_I64), 1) - 1
    take = keep & (order < counts)
    dest = torch.where(take, order, torch.full_like(order, cap))
    out = torch.zeros((S, cap + 1), dtype=_I64, device=dev).scatter_(1, dest, cand)
    return out[:, :cap], take.sum(1).to(torch.int32)


def sample_sets(roots: torch.Tensor, specs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every query set of a proof: a CPU tensor runs `sample_sets_ref`, a
    CUDA tensor one launch of kernel B (or raises)."""
    if roots.device.type == "cpu":
        return sample_sets_ref(roots, specs)
    return kernels.sample_queries(roots.contiguous(), specs)


def compact(values: torch.Tensor, keep: torch.Tensor, cap: int):
    """The kept entries of `values` (flattened, in order), zero-padded to
    cap, and their count: the variable-length analog of concatenating the
    host's lists (`concat_sections`, fused.py:1063)."""
    values, keep = values.reshape(-1), keep.reshape(-1)
    order = torch.cumsum(keep.to(_I64), 0) - 1
    dest = torch.where(keep & (order < cap), order, torch.full_like(order, cap))
    out = torch.zeros(cap + 1, dtype=values.dtype, device=values.device)
    return out.scatter_(0, dest, values)[:cap], keep.sum()


def dedup_rows(cand: torch.Tensor, live: torch.Tensor, cap: int):
    """First-occurrence ordered dedup of each row of cand int64 [S, n]
    over its live entries -> (out int64 [S, cap] zero-padded, found [S])."""
    S, n = cand.shape
    ci = torch.arange(n, device=cand.device)
    earlier = ci[:, None] > ci[None, :]
    dup = ((cand[:, None, :] == cand[:, :, None]) & earlier & live[:, None, :]).any(-1)
    keep = live & ~dup
    order = torch.cumsum(keep.to(_I64), 1) - 1
    dest = torch.where(keep & (order < cap), order, torch.full_like(order, cap))
    out = torch.zeros((S, cap + 1), dtype=cand.dtype, device=cand.device)
    return out.scatter_(1, dest, cand)[:, :cap], keep.sum(1)


def augment_stark(positions: torch.Tensor, ext: int, domain_size: int):
    """The spot checks' positions: p then (p + ext) mod N for each p,
    insertion-ordered dedup.  positions int64 [C] -> ([2C], found)."""
    nxt = (positions + ext) & (domain_size - 1)
    inter = torch.stack([positions, nxt], dim=1).reshape(1, -1)
    out, found = dedup_rows(inter, torch.ones_like(inter, dtype=torch.bool), inter.shape[1])
    return out[0], found[0]


def augment_fri(positions: torch.Tensor, live: torch.Tensor, row_masks: torch.Tensor):
    """fri.get_augmented_positions for S sets at once: p mod rowLength,
    insertion-ordered dedup.  positions int64 [S, C], live bool [S, C],
    row_masks int64 [S] (rowLength - 1 = column_length / 4 - 1) -> ([S, C],
    found [S])."""
    return dedup_rows(positions & row_masks[:, None], live, positions.shape[1])


def plan_rows_batch(positions: torch.Tensor, live: torch.Tensor, depths: torch.Tensor,
                    offsets: torch.Tensor, bases: torch.Tensor):
    """merkle.plan_batch's fetch rows for P plans at once.

    positions int64 [P, C] (dead slots are padding), live bool [P, C],
    depths int64 [P], offsets int64 [P, D] = level_offset(n_p, level) for
    each level below D >= every depth, bases int64 [P] (each tree's first
    row in its buffer).  Returns (rows, keep), both [P, C + D C]: plan p's
    rows in plan_batch order are rows[p][keep[p]] — the leaves base + p,
    then per level (ascending), in caller order, the sibling row of each
    position processed first at that level whose sibling is no position's
    node there (merkle/__init__.py plan_batch)."""
    P, C = positions.shape
    D = offsets.shape[1]
    ci = torch.arange(C, device=positions.device)
    lv = torch.arange(D, device=positions.device)
    idx = positions[:, None, :] >> lv[None, :, None]                 # [P, D, C]
    sib = idx ^ 1
    live_j = live[:, None, None, :]
    # [P, D, i, j]: node j equals node i / the sibling of node i
    same = (idx[:, :, None, :] == idx[:, :, :, None]) & live_j
    at_sib = (idx[:, :, None, :] == sib[:, :, :, None]) & live_j
    earlier = ci[:, None] > ci[None, :]
    first = live[:, None, :] & ~((same | at_sib) & earlier).any(-1)
    emit = first & ~at_sib.any(-1) & (lv[None, :] < depths[:, None])[:, :, None]
    coords = bases[:, None, None] + offsets[:, :, None] + sib
    rows = torch.cat([bases[:, None] + positions, coords.reshape(P, D * C)], dim=1)
    keep = torch.cat([live, emit.reshape(P, D * C)], dim=1)
    return rows, keep


def plan_rows_dev(positions: torch.Tensor, n_pos: int, depth: int, n_leaves: int,
                  level_offset) -> Tuple[torch.Tensor, torch.Tensor]:
    """One plan's fetch rows (the JAX `plan_rows_dev` contract): positions
    int64 [Cp] of which the first n_pos are live -> (rows int64 [Cp (1 +
    depth)] zero-padded, n_rows)."""
    Cp = positions.shape[0]
    dev = positions.device
    live = (torch.arange(Cp, device=dev) < n_pos)[None]
    offsets = torch.as_tensor([[level_offset(n_leaves, lv) for lv in range(depth)]],
                              dtype=_I64, device=dev)
    rows, keep = plan_rows_batch(positions[None].to(_I64), live,
                                 torch.full((1,), depth, dtype=_I64, device=dev), offsets,
                                 torch.zeros(1, dtype=_I64, device=dev))
    return compact(rows, keep, Cp * (1 + depth))
