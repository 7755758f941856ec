"""The prover's main path on one torch device.

Counterpart of ``genstark_tpu/protocol/fused.py`` (`FusedProver`), single
device, with the Fiat-Shamir transcript on the device: a warm prove
uploads its inputs (trace, statics) asynchronously from pinned memory and
synchronizes once, at the one fetch of the proof's bytes, as the JAX
package's one-program default path does (`prove`, fused.py:1280-1361).

1. commit (`_stage_commit`): trace -> Montgomery, iNTT with T^-1 folded,
   LDE to Ne with R^-1 folded (the committed evaluations come out in
   standard form), secret static registers likewise, leaf hashing (kernel
   3) and the evaluation tree (kernel 2); its root stays on the device.
2. composition + linear combination (`_lcomb_chunked` with one chunk):
   the coefficients are drawn on the device from prng(e_root)
   (protocol/fiat_shamir.py, `transcript_coefficients_dev`); constraints
   are evaluated over the composition domain, combined, interpolated (Nc^-1
   folded) and extended to Ne; boundary quotients are divided exactly and
   extended; the pointwise tail runs as kernel 4.
3. FRI (`_stage_fri`): per layer, row hashing (kernel 3), the layer tree
   (kernel 2), specialX = prng(root) and its square on the device, and the
   fold.
4. the tail (`_packed_tail`): every query set sampled by one launch of
   kernel B, the augmentations and batch-proof plans as batched torch
   (protocol/device_queries.py), one gather of every proof byte, the
   positions and the roots: ONE transfer.  The host re-derives each
   position set from the fetched roots with queries.py (every prove) and
   `_assemble`s; on any difference, or a set the device's candidate window
   did not fill, it takes the host-sampled path (`_host_plans` + `_gather`,
   the JAX package's fallback) and counts it in `host_fallbacks`.  The
   bytes are the same either way.

Every transform is a chain of DFT levels (kernel 1) for the solinas fields
(p32, 2^64 - 2^32 + 1, p128, p224, p256 and the others whose solinas_spec
counts the field's limbs), and the radix-2 path (kernels 8
and 5, plus the stage kernels 7 and 9 above 2^21 points) for the others,
P64 among them (ntt/__init__.py `make_plan`).

Large domains (the JAX package's split mode, `fused.py:203-224`, from
Ne = 2^22): the stages drop each full-domain tensor as soon as nothing
reads it again, so the peak follows the live set (at Ne = 2^24 and L = 16
one [L, Ne] vector is 1 GB).  The chunked tail (`fused.py:737-756`) is not
ported: kernel 4 takes any Ne in one launch.
Power tables longer than 4096 entries are uploaded factored — outer powers
of seed^s and inner powers of seed — and regenerated on the device by one
outer-table multiply (kernel 6; or consumed factored by kernel 4).  Every
other field op is one elementwise kernel launch (kernel 5).  Tables, plans,
the zerofier's inverse numerators and the tail's index structure are
uploaded at a Prover's first prove and kept.  None of them reads an
asserted value: the boundary quotients are the floor quotients of the trace
polynomials by the zerofiers, which the interpolants I(x) do not move (see
`BoundaryConstraints.evaluate_all_tables`), so one Prover proves every
statement with the same asserted steps and registers.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import tracing
from ..field.limbs import limbs_to_ints, power_series_mont_np
from ..merkle import assemble_batch, build_tree_flat, level_offset, plan_batch, tree_row_count
from ..ntt import make_plan, transform
from . import device_queries as dq
from .composition import CompositionPolynomial, transcript_coefficients_dev
from .fiat_shamir import prng_single_dev, root_words
from .fri import MAX_REMAINDER_LENGTH, fold, get_augmented_positions, verify_remainder
from .lincomb import LinearCombination
from .lincomb_kernel import lcomb_tail
from .proof import FriComponent, LowDegreeProof, StarkProof


def _to_mont_batch(dev, x_std: torch.Tensor) -> torch.Tensor:
    """int32 [B, L, N] standard form on the device -> [B, L, N] Montgomery
    (the limb axis moves to the front for the field ops)."""
    return dev._to_mont(x_std.permute(1, 0, 2)).permute(1, 0, 2).contiguous()


class Prover:
    """One instance per (Stark, proving-context shape, asserted steps and
    registers); `assertions` give the structure, their values are not
    read."""

    # Tables longer than this are uploaded factored (see the module doc).
    _factor_threshold = 4096

    def __init__(self, stark, context, assertions, dev):
        # no reference to `stark`: the Stark caches its provers, and a cycle
        # would keep a dropped Stark's device tables until the cyclic collector
        self.index_generator = stark.index_generator
        self.context = context
        self.field = context.field
        self.dev = dev
        self.hash = stark.hash
        self.c_poly = CompositionPolynomial(assertions, None, context)
        self.l_comb = LinearCombination(None, self.c_poly.composition_degree, 0, context)
        Ne = context.evaluation_domain_size
        self.Ne = Ne
        self.layer_sizes: List[int] = []
        n = Ne
        while n > MAX_REMAINDER_LENGTH:
            self.layer_sizes.append(n)
            n //= 4
        self.remainder_size = n
        self.secret_idx = list(context.schema.secret_input_registers)
        self._kept = {}              # per-prover device tensors (see _keep)
        self.host_fallbacks = 0      # proves that took the host-sampled path
        # caps of the padded proof gather (fused.py:226-248): every index
        # section has a fixed length, so the one buffer has a fixed layout
        exe_q = self.index_generator.exe_query_count
        fri_q = self.index_generator.fri_query_count
        depths = [n.bit_length() - 1 for n in self._tree_sizes()]
        pos_caps = [2 * exe_q, exe_q] + [fri_q] * (2 * len(self.layer_sizes))
        cap_rows_e = pos_caps[0] * (1 + depths[0])
        cap_rows_f = sum(c * (1 + depths[t])
                         for c, t in zip(pos_caps[1:], self._plan_trees()[1:]))
        cap_cols = self.remainder_size + 4 * (exe_q + 2 * fri_q * len(self.layer_sizes))
        self._caps = (cap_rows_e, cap_rows_f, cap_cols, 2 * exe_q)

    # --------------------------------------------------------------- tables
    def _table_specs(self):
        """Every power table the pipeline needs, as (key, seed, length)."""
        context = self.context
        f = self.field.host
        T, Ne = context.trace_length, self.Ne
        Nc = context.composition_domain_size
        rou = context.root_of_unity
        specs = [("dom_fwd", rou, Ne)]
        for d in range(len(self.layer_sizes)):
            g_d = f.exp(rou, 4 ** d)
            m_d = (Ne // (4 ** d)) // 4
            specs.append((f"fold{d}", g_d, m_d))
            specs.append((f"foldi{d}", f.inv(g_d), m_d))
        incr = self.c_poly.composition_degree - T
        if incr > 0:
            specs.append(("incr", f.exp(rou, incr), Ne))
        comp_rou = f.exp(rou, Ne // Nc)
        for gi, group in enumerate(self.c_poly.constraint_groups):
            if group["degree"] != self.c_poly.combination_degree:
                inc = self.c_poly.combination_degree - group["degree"]
                specs.append((f"adj{gi}", f.exp(comp_rou, inc), Nc))
        for b, c in enumerate(self.c_poly.b_poly.polys.values()):
            for j, root in enumerate(c["xs"]):
                specs.append((f"bc{b}_{j}", root, T))
                specs.append((f"bci{b}_{j}", f.inv(root), T))
        return specs

    def _factored(self, ln: int):
        """(s, nj) split for a factored table, or None for direct upload."""
        if ln <= self._factor_threshold:
            return None
        s = 1 << ((ln.bit_length() - 1) // 2)
        return s, ln // s

    def _get_tables(self) -> Dict[str, tuple]:
        """key -> ("direct", table) or ("factored", outer, inner), on the
        device, built by host big-int arithmetic once per prover."""
        return self._keep("tables", self._make_tables)

    def _make_tables(self) -> Dict[str, tuple]:
        params = self.field.params
        p = self.field.modulus
        dev = self.dev
        tabs = {}
        for key, seed, ln in self._table_specs():
            fac = self._factored(ln)
            if fac is None:
                tabs[key] = ("direct", dev.from_numpy(power_series_mont_np(params, seed, ln)))
            else:
                s, nj = fac
                tabs[key] = ("factored",
                             dev.from_numpy(power_series_mont_np(params, pow(seed % p, s, p), nj)),
                             dev.from_numpy(power_series_mont_np(params, seed, s)))
        return tabs

    def _table(self, key: str) -> torch.Tensor:
        t = self._get_tables()[key]
        return t[1] if t[0] == "direct" else self.dev.outer_table(t[1], t[2])

    def _parts(self, key: str):
        """(outer [L, nj], inner [L, s]) of a table; a direct table is its
        own inner part under an outer of one Montgomery one."""
        t = self._get_tables()[key]
        if t[0] == "factored":
            return t[1], t[2]
        return self.dev.one((1,)), t[1]

    def _keep(self, key: str, make):
        """A device tensor (or tuple) made at the first prove and kept: a
        warm prove uploads nothing after its inputs."""
        if key not in self._kept:
            with tracing.span("prover.keep"):
                self._kept[key] = make()
        return self._kept[key]

    def _tree_sizes(self) -> List[int]:
        """Leaves of each committed tree: the evaluation tree, then one per
        FRI layer (the remainder's included)."""
        return [self.Ne] + [n // 4 for n in self.layer_sizes + [self.remainder_size]]

    def _plan_trees(self) -> List[int]:
        """The tree of each batch proof, in the host's order: the
        evaluation tree, the lc tree, then per FRI layer i the column tree
        i + 2 and the poly tree i + 1."""
        return [0, 1] + [t for i in range(len(self.layer_sizes)) for t in (i + 2, i + 1)]

    def _get_plans(self) -> Dict[str, object]:
        """Transform plans (digit DFT or radix-2, ntt.make_plan): the scale
        folds T^-1 / Nc^-1 into the inverse transforms and R^-1 into the
        standard-form LDE."""
        return self._keep("plans", self._make_plans)

    def _plan_specs(self) -> Dict[str, tuple]:
        """key -> (n, root, scale) of every transform the pipeline runs."""
        field, f = self.field, self.field.host
        p = field.modulus
        T = self.context.trace_length
        Ne, Nc = self.Ne, self.context.composition_domain_size
        return {
            "w_T_inv": (T, f.inv(f.get_root_of_unity(T)), f.inv(T % p)),
            "w_Ne": (Ne, f.get_root_of_unity(Ne), 1),
            "w_Ne_std": (Ne, f.get_root_of_unity(Ne), f.inv(field.params.R_mod % p)),
            "w_Nc": (Nc, f.get_root_of_unity(Nc), 1),
            "w_Nc_inv": (Nc, f.inv(f.get_root_of_unity(Nc)), f.inv(Nc % p)),
        }

    def _make_plans(self) -> Dict[str, object]:
        return {k: make_plan(self.field, self.dev, n, root, scale)
                for k, (n, root, scale) in self._plan_specs().items()}

    def _transform(self, x: torch.Tensor, key: str) -> torch.Tensor:
        return transform(self.dev, x, self._get_plans()[key])

    def _lde(self, x: torch.Tensor, n: int, key: str) -> torch.Tensor:
        return self._transform(torch.nn.functional.pad(x, (0, n - x.shape[-1])), key)

    # ---------------------------------------------------------------- stages
    def _stage_commit(self, trace_std: torch.Tensor, statics_std):
        """Trace interpolation, LDE, secret-register evaluations, evaluation
        tree, from the uploaded standard-form trace [R, L, T] and statics
        [K, L, T] (or None).  Returns (p_polys, static_polys, e_std, e_flat,
        e_root), the root as int32 [8] words on the device."""
        dev = self.dev
        Ne = self.Ne
        trace = _to_mont_batch(dev, trace_std)                      # [R, L, T]
        p_polys = self._transform(trace, "w_T_inv")
        del trace
        e_vectors = [self._lde(p_polys, Ne, "w_Ne_std")]            # [R, L, Ne] std
        static_polys = None
        if statics_std is not None:
            statics = _to_mont_batch(dev, statics_std)              # [K, L, T]
            static_polys = self._transform(statics, "w_T_inv")
            if self.secret_idx:
                # a device index: indexing by a list would upload it, a sync
                idx = self._keep("secret_idx", lambda: tracing.upload(
                    self.secret_idx, torch.int64, dev.device))
                e_vectors.append(self._lde(static_polys.index_select(0, idx), Ne, "w_Ne_std"))
        e_std = torch.cat(e_vectors).contiguous()                    # [V, L, Ne]
        del e_vectors
        leaves = self.hash.merge_element_rows(e_std, self.field.element_size)
        e_flat = self._commit_tree(leaves, Ne)
        return p_polys, static_polys, e_std, e_flat, root_words(e_flat)

    def _commit_tree(self, leaves: torch.Tensor, n: int) -> torch.Tensor:
        """The flat tree over the leaves [8, n] (a mesh: its part)."""
        return build_tree_flat(self.hash, leaves, n)

    def _next_evals(self, p_evals: torch.Tensor, shift: int) -> torch.Tensor:
        """P(x * g) over the composition domain: p_evals rolled by one trace
        step, `shift` = Nc / T positions (a mesh: its halo exchange)."""
        return torch.roll(p_evals, -shift, dims=-1)

    def _inv_series(self) -> torch.Tensor:
        """1 / (Z's numerators), [L, ext], periodic over the evaluation
        domain (a mesh: from the rank's first position)."""
        return self._keep("inv_series",
                          lambda: self.dev.from_ints(self.c_poly.z_poly.inverse_numerators()))

    def _coefficients(self, e_root: torch.Tensor):
        """Transcript coefficients from prng(e_root) on the device
        (fused.py:713-725): d and b out of Montgomery form (they multiply
        Montgomery terms), l in it (it multiplies the standard-form
        evaluations)."""
        V = self.context.schema.trace_width + len(self.secret_idx)
        n_ps = V * (2 if self.l_comb.ps_incremental_degree > 0 else 1)
        d, b, l = transcript_coefficients_dev(
            self.dev, e_root,
            (self.c_poly.d_coefficient_count, self.c_poly.b_coefficient_count, n_ps))
        return self.dev._from_mont(d), self.dev._from_mont(b), l

    def _stage_lcomb(self, p_polys, static_polys, e_std, e_root) -> torch.Tensor:
        """Composition polynomial + random linear combination -> L(x)
        [L, Ne] in standard form."""
        context = self.context
        dev = self.dev
        c_poly = self.c_poly
        Ne, T = self.Ne, context.trace_length
        Nc = context.composition_domain_size
        d_coeffs, b_coeffs, l_coeffs = self._coefficients(e_root)

        # constraints over the composition domain, degree-adjusted, combined
        static_evals = (self._lde(static_polys, Nc, "w_Nc")
                        if static_polys is not None else [])
        p_evals = self._lde(p_polys, Nc, "w_Nc")
        n_evals = self._next_evals(p_evals, Nc // T)
        with tracing.span("lcomb.constraints"):
            q_evals = context.evaluate_transition_constraints_over(
                dev, p_evals, n_evals, [static_evals[k] for k in range(len(static_evals))])
            qa = [q_evals[i] for i in range(q_evals.shape[0])]
            for gi, group in enumerate(c_poly.constraint_groups):
                if group["degree"] == c_poly.combination_degree:
                    continue
                powers = self._table(f"adj{gi}")
                for i in group["indexes"]:
                    qa.append(dev.mont_mul(qa[i], powers))
            qc = dev.combine_many_mont(qa, d_coeffs)                # [L, Nc] std
        del qa, q_evals, p_evals, n_evals, static_evals
        qc_poly = self._transform(qc, "w_Nc_inv")
        del qc
        qe = self._lde(qc_poly, Ne, "w_Ne")                         # [L, Ne] std
        del qc_poly

        # boundary quotients, extended to the evaluation domain
        with tracing.span("lcomb.boundary"):
            bdiv = [[(self._table(f"bc{b}_{j}"), self._table(f"bci{b}_{j}"))
                     for j in range(len(c["xs"]))]
                    for b, c in enumerate(c_poly.b_poly.polys.values())]
            b_stack = torch.stack(c_poly.b_poly.evaluate_all_tables(
                dev, p_polys, bdiv, lambda x: self._lde(x, Ne, "w_Ne")))

        # the pointwise tail (kernel 4)
        with tracing.span("lcomb.tail"):
            z = c_poly.z_poly
            inv_series = self._inv_series()                         # [L, ext]
            b_inc = c_poly.composition_degree - T > 0
            ps_inc = self.l_comb.ps_incremental_degree > 0
            incr_parts = self._parts("incr") if (b_inc or ps_inc) else None
            # the tail is the last reader of qe and b_stack: they go with this frame
            return lcomb_tail(dev, qe, b_stack, e_std, self._parts("dom_fwd"), incr_parts,
                              inv_series, z.x_at_last_step, b_coeffs, l_coeffs,
                              b_inc, ps_inc, context.extension_factor)

    def _stage_fri(self, l_evals: torch.Tensor):
        """The fold-by-4 FRI chain with a committed tree per layer (the
        remainder layer included); each layer's specialX and its square are
        drawn on the device from its root (fused.py:983-987).  Returns
        (tree flats, layer values, roots as int32 [8] words)."""
        dev = self.dev
        field = self.field
        rou = self.context.root_of_unity
        flats, layers, roots = [], [], []
        values = l_evals
        for depth, n in enumerate(self.layer_sizes + [self.remainder_size]):
            layers.append(values)
            rows = self.hash.digest_stride_rows(values, field.element_size)
            flat = build_tree_flat(self.hash, rows, n // 4)
            flats.append(flat)
            roots.append(root_words(flat))
            if depth < len(self.layer_sizes):
                s = prng_single_dev(dev, roots[-1])                 # [L, 1] Montgomery
                values = fold(dev, field, rou, self.Ne, depth, values, s, dev.mont_mul(s, s),
                              (self._table(f"fold{depth}"), self._table(f"foldi{depth}")))
        return flats, layers, roots

    # ------------------------------------------------------------------ prove
    def prove(self, trace_std: np.ndarray) -> StarkProof:
        """upload -> commit -> lcomb -> FRI -> tail -> ONE fetch -> host
        check -> `_assemble`, each stage a `tracing.span` named
        prove.<stage>."""
        dev = self.dev
        with tracing.span("prove.upload"):
            statics_std = self.context.statics_std()
            # the inputs go up asynchronously: the one fetch is the prove's
            # only synchronization
            trace = dev.from_numpy(trace_std)
            statics = dev.from_numpy(statics_std) if statics_std.shape[0] else None
        with tracing.span("prove.commit"):
            p_polys, static_polys, e_std, e_flat, e_root = self._stage_commit(trace, statics)
        del trace, statics
        with tracing.span("prove.lcomb"):
            l_evals = self._stage_lcomb(p_polys, static_polys, e_std, e_root)
        del p_polys, static_polys
        with tracing.span("prove.fri"):
            flats, layers, roots = self._stage_fri(l_evals)
        del l_evals
        with tracing.span("prove.tail"):
            fri_cat, vals_cat = torch.cat(flats, dim=1), torch.cat(layers, dim=1)
            del flats, layers
            packed = self._packed_tail(e_flat, fri_cat, vals_cat, e_std, e_root, roots)
            packed = np.ascontiguousarray(tracing.fetch(packed).numpy()).view(np.uint32)
        with tracing.span("prove.assemble"):
            proof = self._assemble_device_sampled(packed)
            if proof is not None:
                return proof
            # a set the candidate window did not fill, or positions that
            # differ from the host sampler's: the host-sampled path
            self.host_fallbacks += 1
            hp = self._host_plans(self._fetched_roots(packed))
            return self._assemble(self._gather(hp, e_flat, fri_cat, vals_cat, e_std), hp)

    # ------------------------------------------------ the one-fetch tail
    @staticmethod
    def _n_cand(count: int) -> int:
        """The device sampler's candidate window (fused.py:1035): an odd-hex
        state (P = 1/16) makes runs of ~16 consecutive candidates hash
        alike, so ~16x the need; a set it does not fill goes to the host."""
        return 32 * count + 512

    def _exe_count(self) -> int:
        ext = self.context.extension_factor
        return min(self.index_generator.exe_query_count, self.Ne - self.Ne // ext)

    def _sample_specs(self):
        """(count, max_, exclude, n_cand) of each query set: the execution
        set over Ne, then one set per FRI layer over its column length."""
        ext = self.context.extension_factor
        fri_q = self.index_generator.fri_query_count
        counts = [self._exe_count()] + [fri_q] * len(self.layer_sizes)
        maxes = [self.Ne] + [n // 4 for n in self.layer_sizes]
        return [(c, m, ext, self._n_cand(c)) for c, m in zip(counts, maxes)]

    def _tail_static(self):
        """The tail's index structure, uploaded at the first prove.

        Sets (the sampler's rows): counts, and the FRI augmentation's row
        masks (column_length / 4 - 1: Ne / 4 for the execution set).  Plans
        (`_plan_trees`): depth, level offsets and first row in its buffer;
        and for the column values of plans 1.. (tree t is layer t - 1) the
        layer's first column and its row length."""
        specs = self._sample_specs()
        all_layers = self.layer_sizes + [self.remainder_size]
        tree_sizes = self._tree_sizes()
        fri_offsets = np.cumsum([0] + [tree_row_count(n) for n in tree_sizes[1:]])
        trees = self._plan_trees()
        depths = [tree_sizes[t].bit_length() - 1 for t in trees]
        D = max(depths)
        col_offsets = np.cumsum([0] + all_layers)
        rem_base = int(col_offsets[-2])
        i64 = lambda v: tracing.upload(v, torch.int64, self.dev.device)
        return {
            "counts": i64([c for c, _, _, _ in specs]),
            "row_masks": i64([m // 4 - 1 for _, m, _, _ in specs]),
            "depths": i64(depths),
            "offsets": i64([[level_offset(tree_sizes[t], lv) if lv < d else 0
                             for lv in range(D)] for t, d in zip(trees, depths)]),
            "bases": i64([0] + [int(fri_offsets[t - 1]) for t in trees[1:]]),
            "col_bases": i64([int(col_offsets[t - 1]) for t in trees[1:]]),
            "col_steps": i64([all_layers[t - 1] // 4 for t in trees[1:]]),
            "rem_idx": i64(range(rem_base, rem_base + self.remainder_size)),
        }

    def _packed_tail(self, e_flat, fri_cat, vals_cat, e_std, e_root, fri_roots):
        """The one-fetch tail (fused.py:1038-1156) on the device: sampling
        (kernel B), augmentations and batch-proof plans, the padded gather,
        the positions and the roots, as one int32 buffer:
        [rows_e x 8 | rows_f x 8 | L x cols | V x L x evals | per set:
        positions, found | root words]."""
        st = self._keep("tail", self._tail_static)
        specs = self._sample_specs()
        ext, Ne = self.context.extension_factor, self.Ne
        capRe, capRf, capC, capE = self._caps
        exe_count = specs[0][0]
        cap_s = max(spec[0] for spec in specs)

        # every set at once, each seeded by the next tree's root (the lc
        # root for the execution set, layer i + 1's for layer i)
        roots = torch.stack(fri_roots)                                      # [S, 8]
        idx, found = dq.sample_sets(roots, specs)                           # [S, cap_s]
        exe_pos = idx[0, :exe_count]
        aug_pos, n_aug = dq.augment_stark(exe_pos, ext, Ne)
        live_s = torch.arange(cap_s, device=idx.device)[None] < st["counts"][:, None]
        fri_aug, n_fri_aug = dq.augment_fri(idx, live_s, st["row_masks"])

        # plans: e (aug_pos), lc (fri_aug[0]), then per layer i the column
        # plan (fri_aug[i + 1]) and the poly plan (idx[i + 1], fri_q live)
        C = max(2 * exe_count, cap_s)
        pad = lambda t: torch.nn.functional.pad(t, (0, C - t.shape[-1]))
        pos = torch.cat([pad(aug_pos)[None], pad(fri_aug[:1]),
                         torch.stack([pad(fri_aug[1:]), pad(idx[1:])], dim=1).reshape(-1, C)])
        n_pos = torch.cat([n_aug.reshape(1), n_fri_aug[:1],
                           torch.stack([n_fri_aug[1:], st["counts"][1:]], dim=1).reshape(-1)])
        live = torch.arange(C, device=idx.device)[None] < n_pos[:, None]          # [P, C]
        rows, keep = dq.plan_rows_batch(pos, live, st["depths"], st["offsets"], st["bases"])
        rows_e, _ = dq.compact(rows[0], keep[0], capRe)
        rows_f, _ = dq.compact(rows[1:], keep[1:], capRf)
        # column values of plans 1..: 4 a row, r + j m of the plan's layer
        # (r-major, j inner), after the remainder's fixed prefix
        quad = torch.arange(4, device=idx.device)
        idx4 = (st["col_bases"][:, None, None] + pos[1:, :, None]
                + quad[None, None, :] * st["col_steps"][:, None, None])
        cols, _ = dq.compact(idx4, live[1:, :, None].expand(-1, -1, 4),
                             capC - self.remainder_size)
        cols = torch.cat([st["rem_idx"], cols])
        e_idx = torch.nn.functional.pad(aug_pos, (0, capE - aug_pos.shape[0]))

        checks = []
        for s, (count, _, _, _) in enumerate(specs):
            checks += [idx[s, :count], found[s:s + 1]]
        sections = [self._gather_sections(e_flat, rows_e, fri_cat, rows_f, vals_cat, cols,
                                          e_std, e_idx)]
        sections += [c.to(torch.int32) for c in checks]
        sections += [e_root, roots.reshape(-1)]
        return torch.cat(sections)

    def _tail_layout(self):
        """(offset of the checks, the checks' section lengths, root words)
        of a `_packed_tail` buffer (fused.py:1363)."""
        capRe, capRf, capC, capE = self._caps
        L = self.dev.L
        V = self.context.schema.trace_width + len(self.secret_idx)
        base = capRe * 8 + capRf * 8 + L * capC + V * L * capE
        secs = []
        for count, _, _, _ in self._sample_specs():
            secs += [count, 1]
        return base, secs, (2 + len(self.layer_sizes)) * 8

    def _fetched_roots(self, packed: np.ndarray) -> List[bytes]:
        """The roots at the end of a `_packed_tail` buffer: the evaluation
        root, then each FRI tree's."""
        base, secs, n_roots = self._tail_layout()
        words = packed[base + sum(secs):base + sum(secs) + n_roots].astype("<u4")
        return [words[8 * i:8 * (i + 1)].tobytes() for i in range(n_roots // 8)]

    def _assemble_device_sampled(self, packed: np.ndarray):
        """Check and assemble a `_packed_tail` buffer (fused.py:1379-1416):
        the host sampler (queries.py) re-derives every position set from
        the fetched roots, on every prove, and they must equal the device's
        (found == count included).  Returns None where they do not: the
        caller then takes the host-sampled path."""
        base, secs, _ = self._tail_layout()
        root_bytes = self._fetched_roots(packed)
        idx_gen = self.index_generator
        want = [idx_gen.get_exe_indexes(root_bytes[1], self.Ne)]
        for i, n in enumerate(self.layer_sizes):
            want.append(idx_gen.get_fri_indexes(root_bytes[2 + i], n // 4))
        off = base
        for k, positions in enumerate(want):
            count = secs[2 * k]
            got = packed[off:off + count].astype(np.int64).tolist()
            found = int(packed[off + count])
            off += count + 1
            if found != count or got != positions:
                return None
        return self._assemble(packed, self._host_plans(root_bytes, want))

    def _host_plans(self, root_bytes: List[bytes], sampled=None):
        """Host transcript + batch-proof planning: positions, per-tree plans
        and the gather indices (the JAX package's `_host_plans`, against the
        port's flat tree layout).  `sampled`: the position sets [exe, layer
        0, ...] where the caller has drawn them already."""
        Ne = self.Ne
        idx_gen = self.index_generator
        layer_roots = root_bytes[1:]                            # lc + columns
        lc_root = layer_roots[0]
        exe_positions = (sampled[0] if sampled is not None else
                         idx_gen.get_exe_indexes(lc_root, Ne))

        all_layers = self.layer_sizes + [self.remainder_size]
        tree_sizes = [Ne] + [n // 4 for n in all_layers]
        fri_offsets = np.cumsum([0] + [tree_row_count(n) for n in tree_sizes[1:]])
        plans = []          # (tree_index, positions, depth, emissions, coords)

        def plan(tree_index, positions):
            depth = tree_sizes[tree_index].bit_length() - 1
            emissions, coords = plan_batch(positions, depth)
            plans.append((tree_index, positions, depth, emissions, coords))
            return len(plans) - 1

        augmented_positions = idx_gen.get_augmented_positions(exe_positions, Ne)
        e_plan = plan(0, augmented_positions)
        lc_aug = get_augmented_positions(exe_positions, Ne)
        lc_plan = plan(1, lc_aug)
        comp_plans = []
        for i, n in enumerate(self.layer_sizes):
            column_length = n // 4
            positions = (sampled[1 + i] if sampled is not None else
                         idx_gen.get_fri_indexes(layer_roots[i + 1], column_length))
            augmented = get_augmented_positions(positions, column_length)
            col_plan = plan(i + 2, augmented)   # tree of layer i+1
            poly_plan = plan(i + 1, positions)  # tree of layer i
            comp_plans.append((positions, augmented, col_plan, poly_plan))

        rows_e, rows_f = [], []
        for tree_index, _, _, _, coords in plans:
            n = tree_sizes[tree_index]
            if tree_index == 0:
                rows_e += [level_offset(n, level) + idx for level, idx in coords]
            else:
                base = int(fri_offsets[tree_index - 1])
                rows_f += [base + level_offset(n, level) + idx for level, idx in coords]

        layer_col_offsets = np.cumsum([0] + list(all_layers))
        rem_base = int(layer_col_offsets[-2])
        val_idx = list(range(rem_base, rem_base + self.remainder_size))
        lc_rows = [(0, lc_aug)]
        for i, (positions, augmented, _, _) in enumerate(comp_plans):
            lc_rows.append((i + 1, augmented))      # column values (layer i+1)
            lc_rows.append((i, positions))          # poly row values (layer i)
        for layer, rows in lc_rows:
            m = all_layers[layer] // 4
            base = int(layer_col_offsets[layer])
            val_idx += [base + r + j * m for r in rows for j in range(4)]
        return {"layer_roots": layer_roots, "lc_root": lc_root, "e_root": root_bytes[0],
                "plans": plans, "comp_plans": comp_plans, "e_plan": e_plan,
                "lc_plan": lc_plan, "lc_aug": lc_aug, "rows_e": rows_e,
                "rows_f": rows_f, "val_idx": val_idx, "e_idx": augmented_positions}

    def _gather(self, hp, e_flat, fri_cat, vals_cat, e_std) -> np.ndarray:
        """The host-sampled path's gather: ONE device gather + ONE transfer
        of every proof byte, [rows_e x 8 | rows_f x 8 | L x cols | V x L x
        evals] as u32, each section padded to its cap (`_packed_tail`'s
        layout)."""
        dev_ = e_flat.device

        def idx(values, cap):
            out = np.zeros(cap, dtype=np.int64)
            out[:len(values)] = values
            return tracing.upload(out, torch.int64, dev_)

        capRe, capRf, capC, capE = self._caps
        packed = self._gather_sections(e_flat, idx(hp["rows_e"], capRe), fri_cat,
                                       idx(hp["rows_f"], capRf), vals_cat,
                                       idx(hp["val_idx"], capC), e_std, idx(hp["e_idx"], capE))
        return np.ascontiguousarray(tracing.fetch(packed).numpy()).view(np.uint32)

    def _gather_sections(self, e_flat, rows_e, fri_cat, rows_f, vals_cat, cols, e_std,
                         e_idx) -> torch.Tensor:
        """[rows_e x 8 | rows_f x 8 | L x cols | V x L x evals] from the
        trees, the FRI layers and the committed evaluations, by the rows,
        columns and positions of the whole domain (a mesh: each rank takes
        what it holds and one all_reduce combines them)."""
        return torch.cat([e_flat[:, rows_e].T.reshape(-1), fri_cat[:, rows_f].T.reshape(-1),
                          vals_cat[:, cols].reshape(-1), e_std[:, :, e_idx].reshape(-1)])

    def _assemble(self, packed: np.ndarray, hp) -> StarkProof:
        """Unpack a gathered buffer (`_packed_tail`'s or `_gather`'s: the
        same section layout) into the StarkProof (the JAX package's
        `_assemble`)."""
        context = self.context
        field = self.field
        elem = field.element_size
        L = self.dev.L
        V = context.schema.trace_width + len(self.secret_idx)
        rows_e, rows_f = hp["rows_e"], hp["rows_f"]
        val_idx, e_idx = hp["val_idx"], hp["e_idx"]
        capRe, capRf, capC, capE = self._caps
        re_sec = packed[:8 * capRe].reshape(capRe, 8).astype("<u4")
        off = 8 * capRe
        rf_sec = packed[off:off + 8 * capRf].reshape(capRf, 8).astype("<u4")
        off += 8 * capRf
        cols_sec = packed[off:off + L * capC].reshape(L, capC)[:, :len(val_idx)]
        off += L * capC
        evals_sec = packed[off:off + V * L * capE].reshape(V, L, capE)[:, :, :len(e_idx)]

        fetched_e = [re_sec[i].tobytes() for i in range(len(rows_e))]
        fetched_f = [rf_sec[i].tobytes() for i in range(len(rows_f))]
        proofs = []
        off_e = off_f = 0
        for tree_index, positions, depth, emissions, coords in hp["plans"]:
            if tree_index == 0:
                chunk = fetched_e[off_e:off_e + len(coords)]
                off_e += len(coords)
            else:
                chunk = fetched_f[off_f:off_f + len(coords)]
                off_f += len(coords)
            proofs.append(assemble_batch(positions, depth, emissions, chunk))

        all_col_ints = limbs_to_ints(cols_sec)
        remainder = all_col_ints[:self.remainder_size]
        val_ints = all_col_ints[self.remainder_size:]

        # remainder degree check during proving
        n_layers = len(self.layer_sizes)
        verify_remainder(field, context.extension_factor, remainder,
                         self.c_poly.composition_degree // (4 ** n_layers),
                         field.exp(context.root_of_unity, 4 ** n_layers))

        n_ei = len(e_idx)
        ev_ints = limbs_to_ints(np.moveaxis(evals_sec, 1, 0).reshape(L, V * n_ei))
        e_values = [b"".join(ev_ints[v * n_ei + i].to_bytes(elem, "little")
                             for v in range(V)) for i in range(n_ei)]

        def take_rows(count):
            nonlocal val_ints
            chunk, val_ints = val_ints[:4 * count], val_ints[4 * count:]
            return [b"".join(chunk[4 * i + j].to_bytes(elem, "little")
                             for j in range(4)) for i in range(count)]

        lc_proof = proofs[hp["lc_plan"]]
        lc_proof.values = take_rows(len(hp["lc_aug"]))
        components = []
        for i, (positions, augmented, col_plan, poly_plan) in enumerate(hp["comp_plans"]):
            column_proof = proofs[col_plan]
            column_proof.values = take_rows(len(augmented))
            poly_proof = proofs[poly_plan]
            poly_proof.values = take_rows(len(positions))
            components.append(FriComponent(column_root=hp["layer_roots"][i + 1],
                                           column_proof=column_proof,
                                           poly_proof=poly_proof))
        ld_proof = LowDegreeProof(lc_root=hp["lc_root"], lc_proof=lc_proof,
                                  components=components, remainder=remainder)
        e_proof = proofs[hp["e_plan"]]
        e_proof.values = e_values
        return StarkProof(ev_root=hp["e_root"], ev_proof=e_proof, ld_proof=ld_proof,
                          i_shapes=context.input_shapes)
