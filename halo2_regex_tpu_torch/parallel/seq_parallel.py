"""Sequence-parallel DFA scan (the port of
``halo2_regex_tpu.parallel.seq_parallel``): long inputs split along the
byte axis over the mesh's seq axis, the batch over its data axis.

DFA matching is associative -- per-byte transition maps compose as
``(g o f)(x) = g[f[x]]`` -- so a sequence-sharded scan follows the
blockwise recipe:

  1. each shard composes its local per-byte maps into one ``[S]`` map per
     string (the image of every state: the table scan kernel run from
     every state at once, ``B * S`` rows, keeping the last position);
  2. the maps of the shards before each shard are composed, in order (an
     exclusive prefix), and applied to the first state: its entry state;
  3. a second pass rescans the shard's bytes from the entry state,
     emitting per-position states.

The mask set/reset/hold FSMs (reference: src/lib.rs:598-714) are affine
boolean recurrences ``x' = a*x + b`` and shard the same way.  Cross-shard
``i-1`` / ``i+1`` neighbours (shifted end flags, changed-id tests) are the
neighbour shard's edge column, moved to this shard's device.

JAX runs all of this under ``shard_map``, with ``ppermute`` for the halo
columns, a log-step ``ppermute`` ladder for the exclusive prefix and a
``while_loop`` over a ``psum`` for speculation.  The port runs one process
over the grid of devices: each shard's work on its own device, the halo
columns and boundary values moved between devices as tensors, the prefix
as a left fold over the shards in order (exact for integer maps and the
affine pairs, so bit-equal to the ladder), and speculation as a Python
loop over rounds.  Outputs equal the single-device matcher's bit for bit
(tests/test_torch_parallel.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import torch

from ..models.compiled import CompiledRegexModel
from ..ops.scan_torch import _model_arrays, _scan_tm, arrays_on, mask_fsm
from ..witness.result import RegexResult
from .mesh import DATA_AXIS, SEQ_AXIS, Mesh

# pass 1 of the exact scheme writes [n_defs, Ls, rows] int32 for B * S rows:
# the rows go through the scan in groups whose output stays under this
PASS1_BYTES = 1 << 30


def _to(tree, dev: torch.device):
    """A tensor, or a tuple of tensors, moved to ``dev``."""
    if isinstance(tree, tuple):
        return tuple(t.to(dev) for t in tree)
    return tree.to(dev)


def _shift_right(xs: Sequence[torch.Tensor], fill: int = 0) -> List[torch.Tensor]:
    """Global right-shift by one along the sequence axis of the shards'
    [B, Ls] tensors ``xs`` (in seq order, each on its device): out[i] =
    global x[i-1]; position 0 gets ``fill``.  The halo is the previous
    shard's last column."""
    out = []
    for j, x in enumerate(xs):
        prev = torch.full_like(x[:, :1], fill) if j == 0 else xs[j - 1][:, -1:].to(x.device)
        out.append(torch.cat([prev, x[:, :-1]], 1))
    return out


def _shift_left(xs: Sequence[torch.Tensor], fill: int = 0) -> List[torch.Tensor]:
    """out[i] = global x[i+1]; the last position gets ``fill``."""
    n = len(xs)
    out = []
    for j, x in enumerate(xs):
        nxt = torch.full_like(x[:, :1], fill) if j == n - 1 else xs[j + 1][:, :1].to(x.device)
        out.append(torch.cat([x[:, 1:], nxt], 1))
    return out


def _exclusive_prefix_compose(locals_: Sequence, compose: Callable, identity: Callable,
                              reverse: bool = False) -> list:
    """Exclusive prefix-combine of the shards' monoid elements ``locals_``
    (tensors or tuples of tensors, each on its shard's device): element j
    of the result is the composition of the elements of every shard
    strictly before j in processing order (shard 0 first, or shard n-1
    first when ``reverse``), on shard j's device; ``identity(x)`` is the
    identity shaped like the element ``x``.  ``compose(a, b)`` applies
    ``a`` (earlier) then ``b`` (later).  A left fold: n - 1 compositions."""
    n = len(locals_)
    out = [None] * n
    acc = None
    for j in (range(n - 1, -1, -1) if reverse else range(n)):
        x = locals_[j]
        dev = (x[0] if isinstance(x, tuple) else x).device
        out[j] = identity(x) if acc is None else _to(acc, dev)
        acc = compose(out[j], x)
    return out


def _compose_maps(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Apply f then g on state maps [..., S]."""
    return torch.gather(g, -1, f.long())


def _affine_compose(m1, m2):
    """Compose affine boolean maps applied m1-then-m2: (a, b) pairs with
    x' = a*x + b."""
    a1, b1 = m1
    a2, b2 = m2
    return a1 * a2, a2 * b1 + b2


def _affine_identity(m):
    return torch.ones_like(m[0]), torch.zeros_like(m[1])


def _local_affine_fsm(set_f: torch.Tensor, reset_f: torch.Tensor, reverse: bool):
    """The set/reset/hold FSM of one shard ([B, Ls] bool planes) as a
    function of its unknown entry value: out[i] = A[i]*entry + B[i], plus
    the shard's totals (A, B at its last position in walk order).  Set
    wins over reset (lib.rs:613-642).  A[i] is 1 until the walk meets a
    set or reset, B[i] the value of the last one met (``mask_fsm``'s
    running max), both int32: the prefix compositions of JAX's scan of
    ``(a, b) = ((1-set)(1-reset), set)``, without a loop over positions."""
    i32 = torch.int32
    hit = (set_f | reset_f).to(i32)
    if reverse:
        A = (hit.flip(1).cumsum(1) == 0).flip(1).to(i32)
    else:
        A = (hit.cumsum(1) == 0).to(i32)
    Bv = mask_fsm(set_f.t(), reset_f.t(), reverse=reverse).t()
    q = 0 if reverse else -1
    return (A, Bv), (A[:, q], Bv[:, q])


# the columns of a sequence-sharded call, in JAX's order (_SEQ_OUT_SPECS);
# the first 13 are per position, the last 3 per string
_SEQ_KEYS = ("enable", "states_after", "substr_ids_per_def", "is_start_per_def", "endf_per_def",
             "substr_id_sum", "is_start_sum", "is_end_sum", "fwd_mask", "bwd_mask", "mask",
             "masked_characters", "all_substr_ids", "accepted", "has_dead", "match_ok")


def _witness_from_states(arrays, n_defs, chars, lengths, entries, afters) -> dict:
    """Shard-local witness emission of one data row of the mesh, with the
    cross-shard halo exchanges: shard j holds ``arrays[j]`` (the model's
    constants), ``chars[j]`` [B, Ls] uint8, ``lengths[j]`` [B] int32, each
    def's entry state ``entries[j]`` [n_defs, B] and per-position
    after-states ``afters[j]`` [n_defs, B, Ls] int32, all on its device.
    Used by both the exact (map-composition) and speculative matchers.
    Returns the columns of ``_SEQ_KEYS`` on shard 0's device."""
    n = len(chars)
    B, Ls = chars[0].shape
    i32 = torch.int32
    home = chars[0].device
    S = arrays[0]["transition"].shape[-1]
    Ssub = arrays[0]["is_start_table"].shape[-1]

    enable, chars_i32 = [], []
    ids_sum, is_start_sum = [], []
    ids_all, start_all, endf_all, end_u = [], [], [], []
    for j in range(n):
        a, dev = arrays[j], chars[j].device
        pos = j * Ls + torch.arange(Ls, dtype=i32, device=dev)
        en = (pos[None, :] < lengths[j][:, None]).to(i32)
        enable.append(en)
        chars_i32.append(chars[j].to(i32) * en)
        st_flat = a["is_start_table"].reshape(-1)
        en_flat = a["is_end_table"].reshape(-1)
        ids_j, start_j, endu_j = [], [], []
        for d in range(n_defs):
            after = afters[j][d]
            prev = torch.cat([entries[j][d][:, None], after[:, :-1]], 1)
            sub_flat = a["substr_id_table"][d].reshape(-1)
            ids_d = sub_flat[prev.long() * S + after] * en
            ids_j.append(ids_d)
            start_j.append(st_flat[ids_d.long() * Ssub + prev].to(i32))
            # end flag attributed to position i+1 (right-shift across shards)
            endu_j.append(en_flat[ids_d.long() * Ssub + after].to(i32))
        ids_all.append(torch.stack(ids_j, 1))
        start_all.append(torch.stack(start_j, 1))
        end_u.append(endu_j)
        endf_all.append(torch.stack(endu_j, 1) * en[:, None, :])
        ids_sum.append(ids_all[j].sum(1, dtype=i32))
        is_start_sum.append(start_all[j].sum(1, dtype=i32))

    accepted, has_dead = [], []
    first_h = arrays[0]["first_states"]
    lengths_h = lengths[0]
    is_end_sum_sh = [torch.zeros_like(x) for x in ids_sum]
    for d in range(n_defs):
        shifted = _shift_right([end_u[j][d] for j in range(n)])
        is_end_sum_sh = [x + y for x, y in zip(is_end_sum_sh, shifted)]
        # final/acceptance: the state at global position lengths-1; the
        # shard that owns it contributes, the others add 0 (JAX's psum)
        final = torch.zeros(B, dtype=i32, device=home)
        for j in range(n):
            start = j * Ls
            ln = lengths[j]
            idx = (ln - 1 - start).clamp(0, Ls - 1).long()
            cand = torch.gather(afters[j][d], 1, idx[:, None])[:, 0]
            owns = (ln - 1 >= start) & (ln - 1 < start + Ls)
            final = final + torch.where(owns, cand, 0).to(home)
        # empty input: no shard owns byte -1; final = first state
        final = torch.where(lengths_h == 0, first_h[d], final)
        accepted.append(arrays[0]["accept_mask"][d, final.long()])
        has_dead.append(final == arrays[0]["dead_states"][d])

    # mask FSMs with cross-shard entry values
    prev_ids = _shift_right(ids_sum)
    fwd_parts, fwd_tot = [], []
    for j in range(n):
        changed = prev_ids[j] != ids_sum[j]
        st = is_start_sum[j] != 0
        part, tot = _local_affine_fsm(st & changed, ~st & (is_end_sum_sh[j] != 0) & changed,
                                      reverse=False)
        fwd_parts.append(part)
        fwd_tot.append(tot)
    entry_f = _exclusive_prefix_compose(fwd_tot, _affine_compose, _affine_identity)

    next_ids = _shift_left(ids_sum)
    is_start_next = _shift_left(is_start_sum)
    is_end_next = _shift_left(is_end_sum_sh)  # is_end_sum[j+1]
    bwd_parts, bwd_tot = [], []
    for j in range(n):
        changed = next_ids[j] != ids_sum[j]
        en_nx = is_end_next[j] != 0
        part, tot = _local_affine_fsm(en_nx & changed, ~en_nx & (is_start_next[j] != 0) & changed,
                                      reverse=True)
        bwd_parts.append(part)
        bwd_tot.append(tot)
    # for the backward walk, the "earlier" shards are those after this one
    entry_b = _exclusive_prefix_compose(bwd_tot, _affine_compose, _affine_identity, reverse=True)

    cols = {k: [] for k in _SEQ_KEYS[:13]}
    for j in range(n):
        (Af, Bf), (Ab, Bb) = fwd_parts[j], bwd_parts[j]
        fwd = Af * entry_f[j][1][:, None] + Bf  # applied to the initial mask 0: a*0 + b
        bwd = Ab * entry_b[j][1][:, None] + Bb
        mask = fwd * bwd
        for k, v in (("enable", enable[j]), ("states_after", afters[j].permute(1, 0, 2)),
                     ("substr_ids_per_def", ids_all[j]), ("is_start_per_def", start_all[j]),
                     ("endf_per_def", endf_all[j]), ("substr_id_sum", ids_sum[j]),
                     ("is_start_sum", is_start_sum[j]), ("is_end_sum", is_end_sum_sh[j]),
                     ("fwd_mask", fwd), ("bwd_mask", bwd), ("mask", mask),
                     ("masked_characters", mask * chars_i32[j]),
                     ("all_substr_ids", mask * ids_sum[j])):
            cols[k].append(v.to(home))
    out = {k: torch.cat(v, -1) for k, v in cols.items()}
    acc = torch.stack(accepted, 1)
    dead = torch.stack(has_dead, 1)
    out.update(accepted=acc, has_dead=dead, match_ok=acc.all(1) & ~dead.any(1))
    return out


def _local_maps(arrays: dict, chars: torch.Tensor) -> torch.Tensor:
    """Pass 1 of the exact scheme: each def's composed map of the shard's
    bytes ``chars`` [B, Ls], as the image of every state [n_defs, B, S]
    int32.  One table scan over ``B * S`` rows (row ``b * S + s`` scans
    string b from state s), keeping the last position; the rows run in
    groups whose [n_defs, Ls, rows] output stays under ``PASS1_BYTES``."""
    B, Ls = chars.shape
    n_defs = arrays["first_states"].shape[0]
    S = arrays["transition"].shape[-1]
    dev = chars.device
    per_string = n_defs * Ls * S * 4
    group = max(1, min(B, PASS1_BYTES // max(per_string, 1)))
    iota = torch.arange(S, dtype=torch.int32, device=dev)
    maps = torch.empty((n_defs, B, S), dtype=torch.int32, device=dev)
    for b0 in range(0, B, group):
        g = min(group, B - b0)
        rows = chars[b0:b0 + g].repeat_interleave(S, 0)
        init = iota.repeat(g)[None].expand(n_defs, g * S).contiguous()
        last = _scan_tm(arrays, rows, init, plain=False)[:, -1]  # [n_defs, g * S]
        maps[:, b0:b0 + g] = last.reshape(n_defs, g, S)
    return maps


def _scan_hook(arrays: dict) -> Callable:
    """Default per-shard scan from given entries (JAX's ``lax.scan`` hook):
    fn(chars [B, Ls] uint8, entries [n_defs, B]) -> after [n_defs, B, Ls],
    through the table scan (``scan_torch._scan_tm``)."""

    def fn(chars, entries):
        return _scan_tm(arrays, chars, entries, plain=False).permute(0, 2, 1)

    return fn


class _SeqBase:
    """What both sequence-sharded matchers share: the model's constants on
    each device of the mesh, splitting a batch over the grid, and the
    assembly of a data row's shards into the whole batch's columns."""

    def __init__(self, model: CompiledRegexModel, mesh: Mesh):
        self.model = model
        self.mesh = mesh
        arrays = _model_arrays(model)
        self.arrays = {d: arrays_on(arrays, d) for d in dict.fromkeys(mesh.devices.flat)}

    def _split(self, chars, lengths):
        """The shards of a batch: for each data row i, the lists of
        (arrays, chars [Bd, Ls], lengths [Bd]) of its seq shards, each on
        mesh.device(i, j)."""
        chars = torch.as_tensor(chars, dtype=torch.uint8)
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        nd, ns = self.mesh.shape[DATA_AXIS], self.mesh.shape[SEQ_AXIS]
        B, L = chars.shape
        if B % nd or L % ns:
            raise ValueError(f"chars [{B}, {L}] do not split over the {nd} x {ns} mesh")
        Bd, Ls = B // nd, L // ns
        rows = []
        for i in range(nd):
            devs = [self.mesh.device(i, j) for j in range(ns)]
            rows.append(([self.arrays[d] for d in devs],
                         [chars[i * Bd:(i + 1) * Bd, j * Ls:(j + 1) * Ls].to(d).contiguous()
                          for j, d in enumerate(devs)],
                         [lengths[i * Bd:(i + 1) * Bd].to(d).contiguous() for d in devs]))
        return rows

    def _gather(self, outs: List[dict]) -> dict:
        home = self.mesh.device(0, 0)
        return {k: torch.cat([o[k].to(home) for o in outs]) for k in outs[0]}

    def match(self, chars, lengths) -> RegexResult:
        """Full RegexResult view (API parity with BatchMatcher): the
        padded state rows, summed flag columns and enables assembled from
        the sharded columns."""
        out = dict(self(chars, lengths))
        out.pop("spec_rounds", None)
        home = self.mesh.device(0, 0)
        chars = torch.as_tensor(chars, dtype=torch.uint8).to(home)
        lengths = torch.as_tensor(lengths, dtype=torch.int32).to(home)
        return _assemble_result(self.model, out, chars, lengths)


class SeqShardedMatcher(_SeqBase):
    """Matcher whose byte axis is sharded over the mesh's seq axis (and the
    batch over the data axis), by the exact map-composition scheme.  Input
    L must divide by the seq axis size and B by the data axis size.  A
    call returns JAX's dict of sharded columns on ``mesh.device(0, 0)``."""

    @torch.no_grad()
    def __call__(self, chars, lengths) -> dict:
        rows = self._split(chars, lengths)
        n_defs = self.model.n_defs
        outs = []
        for arrays, ch, ln in rows:
            maps = [_local_maps(a, c) for a, c in zip(arrays, ch)]
            entry_maps = _exclusive_prefix_compose(
                maps, _compose_maps,
                lambda m: torch.arange(m.shape[-1], dtype=torch.int32,
                                       device=m.device).expand_as(m).contiguous())
            entries, afters = [], []
            for a, c, em in zip(arrays, ch, entry_maps):
                first = a["first_states"].long()[:, None, None].expand(n_defs, em.shape[1], 1)
                entry = torch.gather(em, 2, first)[..., 0].contiguous()  # [n_defs, B]
                entries.append(entry)
                afters.append(_scan_hook(a)(c, entry))  # pass 2: rescan from the entry
            outs.append(_witness_from_states(arrays, n_defs, ch, ln, entries, afters))
        return self._gather(outs)


class SpeculativeSeqMatcher(_SeqBase):
    """Sequence-sharded matcher using speculative boundary resolution:
    each shard scans once from a speculated entry (the DFA's first state),
    boundary states are exchanged, and only on mismatch does another round
    run.  Always exact (fixed-point iteration, at most n_seq rounds).
    ``per_shard`` picks the shard-local scan:

      "xla"    -- the table scan of the portable scan (``_scan_tm``);
      "pallas" -- ``PallasMatcher.scan_states_tm`` of a split, segmented
                  matcher for the shard's length (``pallas_kwargs`` go to
                  its constructor), one matcher a device.

    Outputs carry ``spec_rounds`` int32 [1]: how many scan rounds the fixed
    point took (1 = speculation was immediately right everywhere) -- data
    row 0's, as the JAX matcher returns it; every data row runs its own
    rounds.
    """

    def __init__(self, model: CompiledRegexModel, mesh: Mesh, per_shard: str = "xla",
                 pallas_kwargs: dict | None = None):
        super().__init__(model, mesh)
        Ls = model.max_chars_size // mesh.shape[SEQ_AXIS]
        if per_shard == "pallas":
            from ..ops.pallas_scan import PallasMatcher

            shard_model = dataclasses.replace(model, max_chars_size=Ls)
            self.pallas = {d: PallasMatcher(shard_model, mode="split", grid_mode="segmented",
                                            device=d, **(pallas_kwargs or {}))
                           for d in self.arrays}

            def hook(dev):
                pm = self.pallas[dev]

                def fn(chars, entries):
                    ctm = chars.to(torch.int32).t()  # [Ls, B] time-major
                    return pm.scan_states_tm(ctm, entries, chars.shape[0]).permute(0, 2, 1)

                return fn

        elif per_shard == "xla":
            def hook(dev):
                return _scan_hook(self.arrays[dev])

        else:
            raise ValueError(f"per_shard={per_shard!r}: expected xla/pallas")
        self.per_shard = per_shard
        self._hooks = {d: hook(d) for d in self.arrays}

    @torch.no_grad()
    def __call__(self, chars, lengths) -> dict:
        rows = self._split(chars, lengths)
        n_defs = self.model.n_defs
        outs, row_rounds = [], []
        for arrays, ch, ln in rows:
            hooks = [self._hooks[c.device] for c in ch]
            firsts = [a["first_states"][:, None].expand(n_defs, c.shape[0]).contiguous()
                      for a, c in zip(arrays, ch)]
            entries, rounds = firsts, 0
            while True:
                afters = [h(c, e) for h, c, e in zip(hooks, ch, entries)]
                new = [firsts[0]] + [afters[j - 1][:, :, -1].to(ch[j].device).contiguous()
                                     for j in range(1, len(ch))]
                changed = any(bool((x != e).any()) for x, e in zip(new, entries))
                entries, rounds = new, rounds + 1
                if not changed:
                    break
            # at exit the entries did not change: `afters` was scanned from
            # the fixed point, so it is the exact per-position state set
            outs.append(_witness_from_states(arrays, n_defs, ch, ln, entries, afters))
            row_rounds.append(rounds)
        out = self._gather(outs)
        out["spec_rounds"] = torch.tensor([row_rounds[0]], dtype=torch.int32,
                                          device=self.mesh.device(0, 0))
        return out


def _assemble_result(model, out, chars, lengths) -> RegexResult:
    """JAX's ``_assemble_result``: the RegexResult of a sequence-sharded
    call's columns ``out`` and its inputs, on their device."""
    B, L = chars.shape
    n_defs = model.n_defs
    i32, dev = torch.int32, chars.device
    enable = out["enable"]
    chars_i32 = chars.to(i32) * enable
    after = out["states_after"]  # [B, n_defs, L] (raw beyond len)
    first = torch.as_tensor(model.first_states, dtype=i32, device=dev)[None, :, None]
    raw = torch.cat([first.expand(B, n_defs, 1), after], 2)
    posL1 = torch.arange(L + 1, dtype=i32, device=dev)
    in_range = posL1[None, None, :] <= lengths[:, None, None]
    dummy = torch.as_tensor(model.dummy_states, dtype=i32, device=dev)[None, :, None]
    states = torch.where(in_range, raw, dummy)
    # flags: is_start_sum covers positions [0..L-1]; index L is structurally
    # false (lib.rs:869).  is_end_sum is the shifted column; its index L
    # equals the summed unshifted flag at L-1.
    is_start_sum = torch.cat([out["is_start_sum"], torch.zeros((B, 1), dtype=i32, device=dev)], 1)
    is_end_sum = torch.cat([out["is_end_sum"], out["endf_per_def"].sum(1, dtype=i32)[:, -1:]], 1)
    return RegexResult(
        all_enable_flags=enable,
        all_characters=chars_i32,
        all_substr_ids=out["all_substr_ids"],
        masked_characters=out["masked_characters"],
        states=states,
        substr_ids_per_def=out["substr_ids_per_def"],
        start_enable=enable[:, None, :] * out["is_start_per_def"],
        end_enable=enable[:, None, :] * out["endf_per_def"],
        is_start_sum=is_start_sum,
        is_end_sum=is_end_sum,
        substr_id_sum=out["substr_id_sum"],
        fwd_mask=out["fwd_mask"],
        bwd_mask=out["bwd_mask"],
        mask=out["mask"],
        accepted=out["accepted"],
        has_dead=out["has_dead"],
        match_ok=out["match_ok"],
    )
