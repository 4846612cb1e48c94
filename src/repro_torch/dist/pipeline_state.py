"""A pipeline rank's share of a pipelined model's parameters and of its
optimizer state, for the process mode of the 1F1B schedule
(``dist.pipeline``: one process a rank).

The single controller keeps the whole flat parameter tree and AdamW's f32
``master``, ``m`` and ``v`` on one device, and a restage only re-packs that
tree.  In the process mode rank ``d`` holds only the units the live
:class:`~repro_torch.dist.pipeline.StagePlan` gives it (rows ``[start,
stop)`` of every leaf of the unit stack), the pinned pieces the model puts
on it (``models.pipeline.piece_owners``: the embedding on rank 0, the final
norm and the head on the last rank, the tied table on both), and the AdamW
state of exactly those.  :class:`RankShare` keeps that layout:

* :meth:`~RankShare.cut` takes a rank's share of a whole tree (the seed's
  draw, which every rank makes, or a checkpoint every rank loads);
* :meth:`~RankShare.clip_norm` is the global gradient norm the update clips
  by (below);
* :meth:`~RankShare.restage` moves the units whose owner a new plan changes,
  with their ``master``, ``m`` and ``v``, before the step that runs it;
* :meth:`~RankShare.gather` assembles the whole tree and state on rank 0's
  host in the flat layout the single controller writes, for a checkpoint;
* :meth:`~RankShare.swap` trades a tree with another rank (the tied table's
  two gradient halves).

Every transfer is a point-to-point message of ``dist.p2p``.

The clip norm.  Both modes clip by ``sqrt(sum(V))``, where ``V`` lists the
f32 sums of squares of the gradient's pieces in one fixed order: the flat
tree's leaves in order, a leaf of the unit stack unit by unit
(:func:`clip_norm`).  The single controller computes ``V`` whole.  In the
process mode each entry is computed by the one rank that holds its piece
(the tied table's by rank 0) and the other ranks put zeros there, so an
all-reduce of ``V`` adds nothing but exact zeros, and every rank takes the
single controller's norm, bit for bit.  (The whole tree's ``global_norm``
sums each stacked leaf in one reduction, whose order no split across ranks
can keep.)
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from ..models.layers import tree_leaves, tree_map

__all__ = ["RankShare", "clip_norm"]

#: message tags: the tied table's swap, a restage, a checkpoint's gather (a
#: batch's messages between two ranks take consecutive tags from these)
_SWAP_TAG, _RESTAGE_TAG, _GATHER_TAG = 1 << 12, 2 << 12, 3 << 12
_STATE = ("m", "v", "master")


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    return x.float().square().sum()


def clip_norm(grads: Mapping[str, Any], stacked: str) -> torch.Tensor:
    """The pipelined steps' global gradient norm of a whole tree: the f32
    square sums of its leaves in flat order, each leaf under ``stacked``
    unit by unit, added in one reduction (module docstring)."""
    parts = []
    for key, sub in grads.items():
        for leaf in tree_leaves(sub):
            if key == stacked:
                parts.extend(_square_sum(leaf[u]) for u in range(int(leaf.shape[0])))
            else:
                parts.append(_square_sum(leaf))
    return torch.sqrt(torch.stack(parts).sum())


class RankShare:
    """What one pipeline rank holds of a flat parameter tree (module
    docstring).

    ``spec`` is the whole tree with leaves that have ``.shape`` and
    ``.dtype`` (``models.model.abstract_params``, meta tensors), in the flat
    tree's key order; ``stacked`` the top-level key of the unit stack
    (leading dimension ``plan.n_layers``); ``owners`` maps every other
    top-level key to the ranks that hold it, the first of them the one
    that counts it in the norm and sends it to a checkpoint.  ``plan`` is
    the live stage plan, read when a share is cut and on every
    :meth:`restage`.
    """

    def __init__(self, spec: Mapping[str, Any], stacked: str, owners: Mapping[str, tuple],
                 plan, rank: int, n_stages: int, transport, peers: list[int]) -> None:
        if sorted(plan.weights) != list(range(n_stages)):
            raise ValueError(f"the plan's stages {sorted(plan.weights)} are not the "
                             f"{n_stages} pipeline ranks")
        self.spec = spec
        self.stacked = stacked
        self.owners = {k: tuple(owners.get(k, range(n_stages))) for k in spec if k != stacked}
        self.plan = plan
        self.rank = rank
        self.n_stages = n_stages
        self.transport = transport
        self.peers = peers
        self.device = transport.device
        #: every rank's [start, stop) units, as the local trees hold them now
        self.bounds = plan.boundaries()

    # -- layout -----------------------------------------------------------------
    @property
    def units(self) -> tuple[int, int]:
        """This rank's ``[start, stop)`` units, as its trees hold them now."""
        return self.bounds[self.rank]

    def cut(self, full: Mapping[str, Any]) -> dict[str, Any]:
        """This rank's share of a whole params-shaped tree, as copies on its
        device, laid out by the live plan (which becomes the share's)."""
        self.bounds = self.plan.boundaries()
        start, stop = self.units
        out = {}
        for key in self.spec:
            if key == self.stacked:
                out[key] = tree_map(lambda leaf: leaf[start:stop].to(self.device, copy=True),
                                    full[key])
            elif self.rank in self.owners[key]:
                out[key] = tree_map(lambda leaf: leaf.to(self.device, copy=True), full[key])
        return out

    def adopt(self, params: Mapping[str, Any], opt_state: Mapping[str, Any]):
        """This rank's ``(params, opt_state)`` from a whole tree and state
        (a checkpoint's), laid out by the live plan."""
        state = {}
        for key, value in opt_state.items():
            state[key] = (value.to(self.device, copy=True) if key == "step"
                          else self.cut(value))
        return self.cut(params), state

    # -- the clip norm ------------------------------------------------------------
    def clip_norm(self, grads: Mapping[str, Any]) -> torch.Tensor:
        """:func:`clip_norm` of the whole gradient, from this rank's share
        of it, on every rank (module docstring)."""
        start, stop = self.units
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        parts = []
        for key, spec in self.spec.items():
            if key == self.stacked:
                n_units = self.plan.n_layers
                for leaf in tree_leaves(grads[key]):
                    parts.extend(_square_sum(leaf[u - start]) if start <= u < stop else zero
                                 for u in range(n_units))
            else:
                mine = self.owners[key][0] == self.rank
                leaves = tree_leaves(grads[key]) if mine else tree_leaves(spec)
                parts.extend(_square_sum(leaf) if mine else zero for leaf in leaves)
        return torch.sqrt(self.transport.all_reduce_sum(torch.stack(parts)).sum())

    # -- transfers ----------------------------------------------------------------
    def swap(self, tree: Any, peer: int, like: Any = None) -> Any:
        """Send ``tree`` to pipeline rank ``peer`` and return what it sent
        back: a tree of ``like``'s structure, shapes and dtypes (``tree``'s
        when None).  The staging buffers are kept for the next swap."""
        like = tree if like is None else like
        sends = [(self.peers[peer], leaf, _SWAP_TAG + k)
                 for k, leaf in enumerate(tree_leaves(tree))]
        recvs = [(self.peers[peer], tuple(leaf.shape), leaf.dtype, _SWAP_TAG + k)
                 for k, leaf in enumerate(tree_leaves(like))]
        it = iter(self.transport.exchange(sends, recvs, pooled=True))
        return tree_map(lambda _: next(it), like)

    def _stacked_trees(self, params, opt_state) -> list:
        """The unit-stack subtrees that move with a unit: the parameters',
        then the optimizer state's (``m``, ``v``, ``master``)."""
        return [params[self.stacked]] + [opt_state[k][self.stacked]
                                         for k in _STATE if k in opt_state]

    def restage(self, params: dict, opt_state: dict) -> tuple[dict, dict]:
        """Move the units whose owner the live plan changes, with their
        ``master``, ``m`` and ``v``, so that this rank's trees hold the
        plan's units (a collective: every rank calls it with the same
        plan).  A plan that moves no unit returns the trees as they are."""
        new = self.plan.boundaries()
        old = self.bounds
        if new == old:
            return params, opt_state
        if sorted(new) != list(range(self.n_stages)):
            raise ValueError(f"the plan's stages {sorted(new)} are not the {self.n_stages} "
                             f"pipeline ranks")
        me = self.rank
        trees = self._stacked_trees(params, opt_state)
        flat = [tree_leaves(t) for t in trees]
        o0, _ = old[me]
        sends, recvs, pieces = [], [], {}
        for a in range(self.n_stages):
            for b in range(self.n_stages):
                lo = max(old[a][0], new[b][0])
                hi = min(old[a][1], new[b][1])
                if a == b or lo >= hi:
                    continue
                k = 0
                for leaves in flat:
                    for leaf in leaves:
                        if a == me:
                            sends.append((self.peers[b], leaf[lo - o0:hi - o0],
                                          _RESTAGE_TAG + k))
                        if b == me:
                            recvs.append((self.peers[a], (hi - lo,) + tuple(leaf.shape[1:]),
                                          leaf.dtype, _RESTAGE_TAG + k))
                        k += 1
                if b == me:
                    pieces[a] = (lo, hi)
        got = iter(self.transport.exchange(sends, recvs))
        received = {a: [[next(got) for _ in leaves] for leaves in flat]
                    for a in sorted(pieces)}
        lo_new, hi_new = new[me]
        out = []
        for i, leaves in enumerate(flat):
            rebuilt = []
            for j, leaf in enumerate(leaves):
                segments = []
                for a in range(self.n_stages):  # ranks in order: units in order
                    lo, hi = max(old[a][0], lo_new), min(old[a][1], hi_new)
                    if lo >= hi:
                        continue
                    segments.append(leaf[lo - o0:hi - o0] if a == me else received[a][i][j])
                rebuilt.append(torch.cat(segments) if len(segments) > 1
                               else segments[0].clone())
            it = iter(rebuilt)
            out.append(tree_map(lambda _: next(it), trees[i]))
        self.bounds = new
        params = {**params, self.stacked: out[0]}
        opt_state = dict(opt_state)
        for k, tree in zip([k for k in _STATE if k in opt_state], out[1:]):
            opt_state[k] = {**opt_state[k], self.stacked: tree}
        return params, opt_state

    def gather(self, params: dict, opt_state: dict) -> tuple[Any, Any]:
        """The whole ``(params, opt_state)`` on rank 0's host, in the flat
        layout and key order of the single controller's (a collective:
        every rank calls it); ``(None, None)`` on the other ranks."""
        me = self.rank
        names = ["params"] + [k for k in _STATE if k in opt_state]
        trees = {"params": params, **{k: opt_state[k] for k in names[1:]}}

        def dtype(name, spec_leaf):
            return spec_leaf.dtype if name == "params" else torch.float32

        def sent_by(r):
            """(key, tree name) pieces rank ``r`` sends rank 0, in order."""
            keys = [self.stacked] if r else []
            keys += [k for k, own in self.owners.items() if own[0] == r and 0 not in own]
            return [(k, n) for n in names for k in keys]

        if me:
            sends = [(self.peers[0], leaf, _GATHER_TAG + k) for k, leaf in enumerate(
                leaf for key, name in sent_by(me) for leaf in tree_leaves(trees[name][key]))]
            self.transport.exchange(sends, [])
            return None, None
        recvs, index = [], []  # every rank's messages in one batch
        for r in range(1, self.n_stages):
            start, stop = self.bounds[r]
            k = 0
            for key, name in sent_by(r):
                for spec_leaf in tree_leaves(self.spec[key]):
                    shape = tuple(spec_leaf.shape)
                    if key == self.stacked:
                        shape = (stop - start,) + shape[1:]
                    recvs.append((self.peers[r], shape, dtype(name, spec_leaf), _GATHER_TAG + k))
                    k += 1
                index.append((r, key, name))
        leaves = iter(self.transport.exchange([], recvs, on_host=True))
        got = {(r, key, name): [next(leaves) for _ in tree_leaves(self.spec[key])]
               for r, key, name in index}

        def whole(name):
            out = {}
            for key in self.spec:
                if key == self.stacked:
                    rows = [[leaf.to("cpu", copy=True)
                             for leaf in tree_leaves(trees[name][key])]]
                    rows += [got[(r, key, name)] for r in range(1, self.n_stages)]
                    leaves = [torch.cat(parts) for parts in zip(*rows)]
                elif 0 in self.owners[key]:
                    leaves = [leaf.to("cpu", copy=True) for leaf in tree_leaves(trees[name][key])]
                else:
                    leaves = got[(self.owners[key][0], key, name)]
                it = iter(leaves)
                out[key] = tree_map(lambda _: next(it), self.spec[key])
            return out

        full_params = whole("params")
        full_state = {}
        for key in opt_state:
            full_state[key] = (opt_state[key].to("cpu", copy=True) if key == "step"
                               else whole(key))
        return full_params, full_state
