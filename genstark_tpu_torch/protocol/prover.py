"""The prover's main path on one torch device.

Counterpart of ``genstark_tpu/protocol/fused.py`` (`FusedProver`), single
device and single program, with the transcript on the host:

1. commit (`_stage_commit`): trace -> Montgomery, iNTT with T^-1 folded,
   LDE to Ne with R^-1 folded (the committed evaluations come out in
   standard form), secret static registers likewise, leaf hashing (kernel
   3) and the evaluation tree (kernel 2); the 32-byte root is fetched.
2. composition + linear combination (`_lcomb_chunked` with one chunk):
   the composition and linear-combination coefficients are drawn on the
   host with HostField.prng(e_root) and uploaded; constraints are evaluated
   over the composition domain, combined, interpolated (Nc^-1 folded) and
   extended to Ne; boundary quotients are divided exactly and extended;
   the pointwise tail runs as kernel 4.
3. FRI (`_stage_fri`): per layer, row hashing (kernel 3), the layer tree
   (kernel 2), the root fetched for specialX = prng(root), and the fold.
4. host: query positions from queries.py, batch-proof plans (as
   `_host_plans`), ONE device gather of every proof byte, and `_assemble`.

Every transform is a chain of DFT levels (kernel 1) for p32 and p128, and
the radix-2 path (kernels 8 and 5, plus the stage kernels 7 and 9 above
2^21 points) for the other fields (ntt/__init__.py).

Large domains (the JAX package's split mode, `fused.py:203-224`, from
Ne = 2^22): the stages drop each full-domain tensor as soon as nothing
reads it again, so the peak follows the live set (at Ne = 2^24 and L = 16
one [L, Ne] vector is 1 GB).  The chunked tail (`fused.py:737-756`) is not
ported: kernel 4 takes any Ne in one launch.
Power tables longer than 4096 entries are uploaded factored — outer powers
of seed^s and inner powers of seed — and regenerated on the device by one
outer-table multiply (kernel 6; or consumed factored by kernel 4).  Every
other field op is one elementwise kernel launch (kernel 5).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from ..field.limbs import ints_to_limbs, limbs_to_ints, power_series_mont_np
from ..merkle import assemble_batch, build_tree_flat, level_offset, plan_batch, tree_row_count
from ..ntt import make_plan, transform
from .composition import CompositionPolynomial, transcript_coefficients
from .fri import MAX_REMAINDER_LENGTH, fold, get_augmented_positions, verify_remainder
from .lincomb import LinearCombination
from .lincomb_kernel import lcomb_tail
from .proof import FriComponent, LowDegreeProof, StarkProof


def _to_mont_batch(dev, arr_std: np.ndarray) -> torch.Tensor:
    """u32 [B, L, N] standard form -> int32 [B, L, N] Montgomery on the
    device (the limb axis moves to the front for the field ops)."""
    x = dev.from_numpy(arr_std).permute(1, 0, 2)
    return dev._to_mont(x).permute(1, 0, 2).contiguous()


def _root_bytes(flat: torch.Tensor) -> bytes:
    """32-byte root of a flat tree (its last row), fetched to the host."""
    words = np.ascontiguousarray(flat[:, -1].cpu().numpy())
    return words.view("<u4").tobytes()


class Prover:
    """One instance per (Stark, proving-context shape, assertion values)."""

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
        self.l_comb = LinearCombination(self.c_poly.composition_degree, context)
        Ne = context.evaluation_domain_size
        self.Ne = Ne
        self.layer_sizes: List[int] = []
        n = Ne
        while n > MAX_REMAINDER_LENGTH:
            self.layer_sizes.append(n)
            n //= 4
        self.remainder_size = n
        self.secret_idx = list(context.schema.secret_input_registers)
        self._tables = None
        self._plans = None

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
        if self._tables is None:
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
            self._tables = tabs
        return self._tables

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

    def _get_plans(self) -> Dict[str, object]:
        """Transform plans (digit DFT or radix-2, ntt.make_plan): the scale
        folds T^-1 / Nc^-1 into the inverse transforms and R^-1 into the
        standard-form LDE."""
        if self._plans is None:
            field, f = self.field, self.field.host
            p = field.modulus
            T = self.context.trace_length
            Ne, Nc = self.Ne, self.context.composition_domain_size
            specs = {
                "w_T_inv": (T, f.inv(f.get_root_of_unity(T)), f.inv(T % p)),
                "w_Ne": (Ne, f.get_root_of_unity(Ne), 1),
                "w_Ne_std": (Ne, f.get_root_of_unity(Ne), f.inv(field.params.R_mod % p)),
                "w_Nc": (Nc, f.get_root_of_unity(Nc), 1),
                "w_Nc_inv": (Nc, f.inv(f.get_root_of_unity(Nc)), f.inv(Nc % p)),
            }
            self._plans = {k: make_plan(field, self.dev, n, root, scale)
                           for k, (n, root, scale) in specs.items()}
        return self._plans

    def _transform(self, x: torch.Tensor, key: str) -> torch.Tensor:
        return transform(self.dev, x, self._get_plans()[key])

    def _lde(self, x: torch.Tensor, n: int, key: str) -> torch.Tensor:
        return self._transform(torch.nn.functional.pad(x, (0, n - x.shape[-1])), key)

    # ---------------------------------------------------------------- stages
    def _stage_commit(self, trace_std: np.ndarray):
        """Trace interpolation, LDE, secret-register evaluations, evaluation
        tree.  Returns (p_polys, static_polys, e_std, e_flat, e_root)."""
        dev = self.dev
        Ne = self.Ne
        trace = _to_mont_batch(dev, trace_std)                      # [R, L, T]
        p_polys = self._transform(trace, "w_T_inv")
        del trace
        e_vectors = [self._lde(p_polys, Ne, "w_Ne_std")]            # [R, L, Ne] std
        statics_std = self.context.statics_std()
        static_polys = None
        if statics_std.shape[0]:
            statics = _to_mont_batch(dev, statics_std)              # [K, L, T]
            static_polys = self._transform(statics, "w_T_inv")
            if self.secret_idx:
                e_vectors.append(self._lde(static_polys[self.secret_idx], Ne, "w_Ne_std"))
        e_std = torch.cat(e_vectors).contiguous()                    # [V, L, Ne]
        del e_vectors
        leaves = self.hash.merge_element_rows(e_std, self.field.element_size)
        e_flat = build_tree_flat(self.hash, leaves, Ne)
        return p_polys, static_polys, e_std, e_flat, _root_bytes(e_flat)

    def _coefficients(self, e_root: bytes):
        """Transcript coefficients from prng(e_root): d and b in standard
        form (they multiply Montgomery terms), l in Montgomery form (it
        multiplies the standard-form evaluations)."""
        p = self.field.modulus
        R = self.field.params.R_mod
        L = self.dev.L
        V = self.context.schema.trace_width + len(self.secret_idx)
        n_ps = V * (2 if self.l_comb.ps_incremental_degree > 0 else 1)
        d, b, l = transcript_coefficients(
            self.field, e_root,
            (self.c_poly.d_coefficient_count, self.c_poly.b_coefficient_count, n_ps))
        up = lambda ints: self.dev.from_numpy(ints_to_limbs(ints, L))
        return up(d), up(b), up([v * R % p for v in l])

    def _stage_lcomb(self, p_polys, static_polys, e_std, e_root: bytes) -> torch.Tensor:
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
        n_evals = torch.roll(p_evals, -(Nc // T), dims=-1)
        q_evals = context.evaluate_transition_constraints(
            dev, p_evals, n_evals, [static_evals[k] for k in range(len(static_evals))])
        qa = [q_evals[i] for i in range(q_evals.shape[0])]
        for gi, group in enumerate(c_poly.constraint_groups):
            if group["degree"] == c_poly.combination_degree:
                continue
            powers = self._table(f"adj{gi}")
            for i in group["indexes"]:
                qa.append(dev.mont_mul(qa[i], powers))
        qc = dev.combine_many_mont(qa, d_coeffs)                    # [L, Nc] std
        del qa, q_evals, p_evals, n_evals, static_evals
        qc_poly = self._transform(qc, "w_Nc_inv")
        del qc
        qe = self._lde(qc_poly, Ne, "w_Ne")                         # [L, Ne] std
        del qc_poly

        # boundary quotients, extended to the evaluation domain
        i_polys_mont = _to_mont_batch(dev, c_poly.b_poly.i_polys_std())
        bdiv = [[(self._table(f"bc{b}_{j}"), self._table(f"bci{b}_{j}"))
                 for j in range(len(c["xs"]))]
                for b, c in enumerate(c_poly.b_poly.polys.values())]
        b_stack = torch.stack(c_poly.b_poly.evaluate_all(
            dev, p_polys, i_polys_mont, bdiv, lambda x: self._lde(x, Ne, "w_Ne")))

        # the pointwise tail (kernel 4)
        z = c_poly.z_poly
        inv_series = dev.from_ints(z.inverse_numerators())         # [L, ext]
        b_inc = c_poly.composition_degree - T > 0
        ps_inc = self.l_comb.ps_incremental_degree > 0
        incr_parts = self._parts("incr") if (b_inc or ps_inc) else None
        # the tail is the last reader of qe and b_stack: they go with this frame
        return lcomb_tail(dev, qe, b_stack, e_std, self._parts("dom_fwd"), incr_parts,
                          inv_series, z.x_at_last_step, b_coeffs, l_coeffs,
                          b_inc, ps_inc, context.extension_factor)

    def _stage_fri(self, l_evals: torch.Tensor):
        """The fold-by-4 FRI chain with a committed tree per layer (the
        remainder layer included).  Returns (tree flats, layer values,
        roots)."""
        dev = self.dev
        field = self.field
        p = field.modulus
        rou = self.context.root_of_unity
        flats, layers, roots = [], [], []
        values = l_evals
        for depth, n in enumerate(self.layer_sizes + [self.remainder_size]):
            layers.append(values)
            rows = self.hash.digest_stride_rows(values, field.element_size)
            flat = build_tree_flat(self.hash, rows, n // 4)
            flats.append(flat)
            roots.append(_root_bytes(flat))
            if depth < len(self.layer_sizes):
                s = field.prng(roots[-1])
                values = fold(dev, field, rou, self.Ne, depth, values,
                              dev.const(s, shape=(1,)), dev.const(s * s % p, shape=(1,)),
                              (self._table(f"fold{depth}"), self._table(f"foldi{depth}")))
        return flats, layers, roots

    # ------------------------------------------------------------------ prove
    def prove(self, trace_std: np.ndarray) -> StarkProof:
        """The stages run under torch.profiler ranges named prove.<stage>
        (free when no profiler is recording)."""
        with record_function("prove.commit"):
            p_polys, static_polys, e_std, e_flat, e_root = self._stage_commit(trace_std)
        with record_function("prove.lcomb"):
            l_evals = self._stage_lcomb(p_polys, static_polys, e_std, e_root)
        del p_polys, static_polys
        with record_function("prove.fri"):
            flats, layers, roots = self._stage_fri(l_evals)
        with record_function("prove.queries_gather_assemble"):
            hp = self._host_plans([e_root] + roots)
            packed = self._gather(hp, e_flat, torch.cat(flats, dim=1),
                                  torch.cat(layers, dim=1), e_std)
            return self._assemble(packed, hp)

    def _host_plans(self, root_bytes: List[bytes]):
        """Host transcript + batch-proof planning: positions, per-tree plans
        and the gather indices (the JAX package's `_host_plans`, against the
        port's flat tree layout)."""
        Ne = self.Ne
        idx_gen = self.index_generator
        layer_roots = root_bytes[1:]                            # lc + columns
        lc_root = layer_roots[0]
        exe_positions = idx_gen.get_exe_indexes(lc_root, Ne)

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
            positions = idx_gen.get_fri_indexes(layer_roots[i + 1], column_length)
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
        """ONE device gather + ONE transfer of every proof byte:
        [rows_e x 8 | rows_f x 8 | L x cols | V x L x evals] as u32."""
        dev_ = e_flat.device
        idx = lambda v: torch.as_tensor(np.asarray(v, dtype=np.int64), device=dev_)
        packed = torch.cat([
            e_flat[:, idx(hp["rows_e"])].T.reshape(-1),
            fri_cat[:, idx(hp["rows_f"])].T.reshape(-1),
            vals_cat[:, idx(hp["val_idx"])].reshape(-1),
            e_std[:, :, idx(hp["e_idx"])].reshape(-1)])
        return np.ascontiguousarray(packed.cpu().numpy()).view(np.uint32)

    def _assemble(self, packed: np.ndarray, hp) -> StarkProof:
        """Unpack the gathered buffer into the StarkProof (the JAX package's
        `_assemble`)."""
        context = self.context
        field = self.field
        elem = field.element_size
        L = self.dev.L
        V = context.schema.trace_width + len(self.secret_idx)
        rows_e, rows_f = hp["rows_e"], hp["rows_f"]
        val_idx, e_idx = hp["val_idx"], hp["e_idx"]
        off = 0
        re_sec = packed[off:off + 8 * len(rows_e)].reshape(-1, 8).astype("<u4")
        off += 8 * len(rows_e)
        rf_sec = packed[off:off + 8 * len(rows_f)].reshape(-1, 8).astype("<u4")
        off += 8 * len(rows_f)
        cols_sec = packed[off:off + L * len(val_idx)].reshape(L, len(val_idx))
        off += L * len(val_idx)
        evals_sec = packed[off:off + V * L * len(e_idx)].reshape(V, L, len(e_idx))

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
