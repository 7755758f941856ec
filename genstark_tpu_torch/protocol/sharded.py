"""The prover's mesh mode: the main path with the evaluation domain sharded
over the ranks of a `parallel.mesh.Mesh`.

Counterpart of the mesh mode of ``genstark_tpu/protocol/fused.py``
(`FusedProver(..., mesh=)`: :127-141, :203-211, :393-433, :467-556,
:599-784, :950-1000, :1296-1320).  The JAX package is single-controller
and GSPMD places each collective; here every rank runs the same stages on
its block [r n/D, (r + 1) n/D) of every domain-major tensor and calls each
collective itself.  Everything that comes from the host is replicated: the
trace, the statics, the constants and the tables.  Every
rank returns the same StarkProof, byte for byte the single-device one.

Where the collectives are:

- commit: the trace's T-point interpolation (`dist_transform`, replicated
  in and out: one all_to_all_single and one all_gather, or whole on every
  rank where `can_distribute(T, D)` is false); the LDE to Ne (replicated in,
  block out: two all_to_all_single); leaf hashing on the block; the
  evaluation tree as the rank's subtree, one all_gather of the D subtree
  roots and the top log2 D levels on every rank
  (`merkle.build_tree_sharded`).
- lcomb: the LDEs to Nc and Ne as the commit's; the iNTT over Nc from the
  block to replicated coefficients (two all_to_all_single and an
  all_gather); the roll by one trace step as a halo exchange (one
  all_gather of the D blocks' first Nc/T positions); constraint
  evaluation, combination and kernel 4's tail on the block, with the
  rank's slices of the domain-indexed tables (dom_fwd, incr, adj; a
  factored table gives the rows of its outer factor: its inner size, at
  most the square root of its length, divides the block up to 64 ranks,
  and a mesh where it does not is refused).  The boundary tables bc/bci
  index coefficients, not domain positions, and stay whole.
- FRI: per layer one all_to_all_single (`_stride_transpose`) gives each
  rank the values at j, j + M, j + 2M, j + 3M of its own output rows j;
  row hashing, the layer's tree (subtree plus replicated top) and the fold
  are then local.  A layer of fewer than FRI_SHARD_MIN_ROWS rows a rank is
  gathered (one all_gather), and it and every later layer, the remainder
  among them, run whole on every rank.
- tail: the device sampler (kernel B) and the plans run on every rank on
  the replicated roots, so every rank has the same positions: the JAX
  package keeps the host-sampled path under a mesh (fused.py:1305-1309),
  but the one-fetch path needs no host round trip and gives the same
  positions, checked on the host as on one device.  Each rank gathers the
  rows, columns and evaluations it holds into the packed layout, zeros
  elsewhere, and one all_reduce(SUM) on int32 combines them: every entry
  has exactly one owner, so the sum is exact.  Every rank fetches the same
  buffer and assembles the same proof.

The split mode needs nothing of its own: the stages free each domain
tensor after its last reader, as on one device.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..merkle import build_tree_flat, build_tree_sharded, sharded_row_count, sharded_tree_rows
from ..merkle import tree_row_count
from ..parallel.ntt_dist import DistPlan, dist_transform
from .fiat_shamir import prng_single_dev, root_words
from .fri import fold
from .prover import Prover

# A FRI layer is sharded while each rank holds at least this many of its
# rows; below, the layer is gathered and the rest of FRI runs whole on every
# rank.  The value is a guess, not a measurement: where an exchange starts
# to cost more than hashing and folding a rank's rows depends on the link
# between cards, which ranks sharing one card cannot show (PERF.md §7).
FRI_SHARD_MIN_ROWS = 256


class ShardedProver(Prover):
    """The one-fetch prover over a mesh: one instance per rank, the same
    (Stark, context, assertions) on each."""

    def __init__(self, stark, context, assertions, dev, mesh):
        super().__init__(stark, context, assertions, dev)
        D = mesh.size
        T = context.trace_length
        if D & (D - 1) or D > T:
            raise ValueError(f"a mesh of {D} ranks does not split a trace of {T} steps "
                             "(the rank count must be a power of two, at most T)")
        self.mesh = mesh
        self._spec = {key: ln for key, _, ln in self._table_specs()}
        # which FRI layers (the remainder's last) are sharded
        self._fri_sharded, sharded = [], True
        for n in self.layer_sizes:
            sharded = sharded and (n // 4) // D >= FRI_SHARD_MIN_ROWS
            self._fri_sharded.append(sharded)
        self._fri_sharded.append(False)

    # ------------------------------------------------------------ transforms
    def _make_plans(self) -> Dict[str, object]:
        return {k: DistPlan(self.field, self.dev, n, self.mesh, root, scale)
                for k, (n, root, scale) in self._plan_specs().items()}

    def _transform(self, x: torch.Tensor, key: str) -> torch.Tensor:
        """Interpolation to replicated coefficients, from replicated values
        (the trace) or from the rank's block (C(x) over Nc)."""
        plan = self._get_plans()[key]
        inp = "replicated" if x.shape[-1] == plan.n else "block"
        return dist_transform(self.dev, x, plan, self.mesh, inp, "replicated")

    def _lde(self, x: torch.Tensor, n: int, key: str) -> torch.Tensor:
        """Replicated coefficients -> the rank's block of their evaluations."""
        return dist_transform(self.dev, x, self._get_plans()[key], self.mesh,
                              "replicated", "block")

    # ---------------------------------------------------------------- tables
    def _blocked(self, key: str) -> bool:
        """True for the tables indexed by domain position that the rank
        takes its block of (fold tables only on sharded layers)."""
        if key.startswith("fold"):
            return self._fri_sharded[int(key[5:] if key.startswith("foldi") else key[4:])]
        return key in ("dom_fwd", "incr") or key.startswith("adj")

    def _parts(self, key: str):
        """The rank's block of a domain-indexed table as (outer, inner)
        parts: a direct table's slice under an outer of one, or the rows
        of a factored table's outer factor."""
        off, blk = self.mesh.block(self._spec[key])
        t = self._get_tables()[key]
        if t[0] == "direct":
            return self.dev.one((1,)), t[1][:, off:off + blk]
        s = t[2].shape[1]
        if blk % s:
            raise ValueError(f"{self.mesh.size} ranks split table {key} inside its inner "
                             f"factor of {s} entries")
        return t[1][:, off // s:(off + blk) // s], t[2]

    def _table(self, key: str) -> torch.Tensor:
        if not self._blocked(key):
            return super()._table(key)
        outer, inner = self._parts(key)
        if self._get_tables()[key][0] == "direct":
            return inner
        return self.dev.outer_table(outer, inner)

    def _inv_series(self) -> torch.Tensor:
        """Z's inverse numerators from the rank's first position: the
        period-ext series rolled by that position mod ext."""
        off, _ = self.mesh.block(self.Ne)
        ext = self.context.extension_factor
        return self._keep("inv_series_block",
                          lambda: torch.roll(super(ShardedProver, self)._inv_series(),
                                             -(off % ext), dims=-1))

    # ------------------------------------------------------------- exchanges
    def _commit_tree(self, leaves: torch.Tensor, n: int) -> torch.Tensor:
        return build_tree_sharded(self.hash, leaves, n, self.mesh)

    def _next_evals(self, p_evals: torch.Tensor, shift: int) -> torch.Tensor:
        """The roll by `shift` over the sharded domain: the rank's block
        after its first `shift` positions, then the next rank's first
        `shift` (one all_gather of every rank's head).  shift = Nc/T is at
        most the block Nc/D, since D <= T."""
        mesh = self.mesh
        heads = mesh.all_gather(p_evals[..., :shift])
        return torch.cat([p_evals[..., shift:], heads[(mesh.rank + 1) % mesh.size]], dim=-1)

    def _stride_transpose(self, values: torch.Tensor, n: int) -> torch.Tensor:
        """The FRI stride transpose: the rank's natural block [L, n/D] of a
        layer of n = 4M values -> [L, 4 * M/D], the values at j, j + M,
        j + 2M, j + 3M of the rank's output rows j (fri.fold's layout), by
        one all_to_all_single.  Chunk t of M/D values (t = q D + c: quarter
        q, row block c) lives on rank t // 4 and goes to rank c."""
        D, r = self.mesh.size, self.mesh.rank
        L = values.shape[0]
        c = n // 4 // D
        dest = [(4 * r + i) % D for i in range(4)]
        order = sorted(range(4), key=lambda i: (dest[i], i))
        chunks = values.reshape(L, 4, c)
        send = torch.stack([chunks[:, i] for i in order])                   # [4, L, c]
        src = [(q * D + r) // 4 for q in range(4)]
        got = self.mesh.all_to_all(send, [dest.count(k) for k in range(D)],
                                   [src.count(k) for k in range(D)])        # [4 (q), L, c]
        return got.permute(1, 0, 2).reshape(L, 4 * c)

    def _stage_fri(self, l_evals: torch.Tensor):
        """fused.py:950-1000 over the mesh: a sharded layer is stride-
        transposed, hashed, committed (subtree plus replicated top) and
        folded on the rank's rows; the first layer below
        FRI_SHARD_MIN_ROWS rows a rank is gathered and the rest run whole.
        Returns (tree parts, layer values (the rank's natural blocks, or
        whole), roots), as `Prover._stage_fri`."""
        dev, field, mesh = self.dev, self.field, self.mesh
        rou = self.context.root_of_unity
        flats, layers, roots = [], [], []
        values = l_evals
        for depth, n in enumerate(self.layer_sizes + [self.remainder_size]):
            sharded = self._fri_sharded[depth]
            if not sharded and values.shape[-1] != n:
                values = torch.cat(mesh.all_gather(values), dim=-1)
            layers.append(values)
            if sharded:
                rows_in = self._stride_transpose(values, n)
                flat = build_tree_sharded(
                    self.hash, self.hash.digest_stride_rows(rows_in, field.element_size),
                    n // 4, mesh)
            else:
                rows_in = values
                flat = build_tree_flat(
                    self.hash, self.hash.digest_stride_rows(values, field.element_size), n // 4)
            flats.append(flat)
            roots.append(root_words(flat))
            if depth < len(self.layer_sizes):
                s = prng_single_dev(dev, roots[-1])
                values = fold(dev, field, rou, self.Ne, depth, rows_in, s, dev.mont_mul(s, s),
                              (self._table(f"fold{depth}"), self._table(f"foldi{depth}")))
        return flats, layers, roots

    # ------------------------------------------------------------------ tail
    def _layout(self):
        """Index tensors of the rank's buffers, made once: per FRI tree
        (trees 1..) its leaves, whether it is sharded, and its first row in
        the whole concatenation and in the rank's; per layer its length,
        whether it is sharded, and its first column in each."""
        def make():
            D = self.mesh.size
            i64 = lambda v: torch.as_tensor(v, dtype=torch.int64, device=self.dev.device)
            sizes = self._tree_sizes()[1:]
            layers = self.layer_sizes + [self.remainder_size]
            sh = self._fri_sharded
            cum = lambda v: [0] + list(torch.cumsum(torch.as_tensor(v), 0).tolist())
            return {
                "t_n": i64(sizes), "t_sh": torch.as_tensor(sh, device=self.dev.device),
                "t_g": i64(cum([tree_row_count(n) for n in sizes])),
                "t_l": i64(cum([sharded_row_count(n, D) if s else tree_row_count(n)
                                for n, s in zip(sizes, sh)])),
                "c_n": i64(layers),
                "c_g": i64(cum(layers)),
                "c_l": i64(cum([n // D if s else n for n, s in zip(layers, sh)])),
            }
        return self._keep("layout", make)

    def _gather_sections(self, e_flat, rows_e, fri_cat, rows_f, vals_cat, cols, e_std,
                         e_idx) -> torch.Tensor:
        """`Prover._gather_sections` over the mesh: each entry from the rank
        that holds it (rows of a replicated top or layer from rank 0),
        zeros elsewhere, then one all_reduce(SUM)."""
        mesh = self.mesh
        D, r = mesh.size, mesh.rank
        lay = self._layout()
        zero = lambda t: torch.zeros_like(t)

        owner, local = sharded_tree_rows(rows_e, self.Ne, D)
        sec_e = torch.where(owner == r, e_flat[:, local], 0).T.reshape(-1)

        t = torch.searchsorted(lay["t_g"][1:], rows_f, right=True)
        g = rows_f - lay["t_g"][t]
        owner, local = sharded_tree_rows(g, lay["t_n"][t], D)
        sh = lay["t_sh"][t]
        owner = torch.where(sh, owner, zero(owner))
        local = lay["t_l"][t] + torch.where(sh, local, g)
        sec_f = torch.where(owner == r, fri_cat[:, local], 0).T.reshape(-1)

        t = torch.searchsorted(lay["c_g"][1:], cols, right=True)
        q = cols - lay["c_g"][t]
        blk = lay["c_n"][t] // D
        sh = lay["t_sh"][t]
        owner = torch.where(sh, q // blk, zero(q))
        local = lay["c_l"][t] + torch.where(sh, q % blk, q)
        sec_c = torch.where(owner == r, vals_cat[:, local], 0).reshape(-1)

        blk = self.Ne // D
        sec_v = torch.where(e_idx // blk == r, e_std[:, :, e_idx % blk], 0).reshape(-1)
        return mesh.all_reduce_sum(torch.cat([sec_e, sec_f, sec_c, sec_v]))
