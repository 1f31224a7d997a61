"""Array-based search tree (no Python node objects).

The reference's tree is a pointer structure of per-node Python ``Node``
objects traversed one simulation at a time with batch-1 NN inference
(ref ``Search/Node.py:3-12``, ``Search/Explorer.py:49-58``).  Here the
tree is a struct-of-arrays pytree with a fixed node budget per game:

- node stats are ``[num_nodes]`` vectors (visit counts, value sums, ...),
- edges are ``[num_nodes, num_actions]`` tables (priors, child indices).

Each node stores the env state it corresponds to — but PACKED into a flat
``f32[D]`` vector (``utils/packing.py``), so node storage is ``[B, N, D]``
with a large minor dimension and negligible tile padding.  (Storing raw
state pytrees pads small trailing dims 10-60x; re-stepping the env along
the path instead — the reference's ``shallow_clone`` scratch games,
``Explorer.py:51-58`` — would cost an env.step with its own nested stage
loop on every descent edge.  Packed per-node states
make descent pure gathers and run env.step exactly once per simulation.)

A batch of B independent games is this structure vmapped to leading dim B;
every simulation's leaf evaluations across the whole batch fuse into one
batched network call.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from nuzero.utils import struct

UNVISITED = jnp.int32(-1)


@struct.dataclass
class Tree:
    # Per-node arrays, shape [N] (+ batch dims when vmapped).
    visit: jax.Array  # i32 visit counts
    value_sum: jax.Array  # f32 sum of backed-up values (static convention)
    parent: jax.Array  # i32 parent index, -1 at root
    to_play: jax.Array  # i32 player to move at this node
    is_terminal: jax.Array  # bool
    terminal_value: jax.Array  # f32
    expanded: jax.Array  # bool: children priors computed
    # Per-edge arrays, shape [N, A].
    prior: jax.Array  # f32 masked-renormalized priors
    legal: jax.Array  # bool legal-action mask at each node
    child: jax.Array  # i32 child node index or -1
    # DENSE per-edge search statistics, duplicated from the child nodes'
    # visit/value_sum.  PUCT selection needs every child's (visit, q) at
    # the current node; reading them through ``child`` indices is a
    # [num_actions]-wide gather, which the accelerator this was first
    # built for executed serially.  Dense rows make selection a contiguous
    # dynamic-slice and are kept in sync by backprop crediting each
    # descended edge.  Whether they pay on the GPU is not yet measured
    # (ROADMAP 1.4).
    child_visit: jax.Array  # i32[N, A] visit counts of each edge's target
    child_vsum: jax.Array  # f32[N, A] value sums of each edge's target
    # Packed env state per node, f32[N, D] (see utils/packing.py).
    states: jax.Array
    # Scalars / allocator.  The root is an INDEX, not a fixed slot:
    # subtree reuse re-points it instead of compacting the arrays
    # (see ``reroot``), so node ids stay stable for the tree's lifetime.
    root: jax.Array  # i32 current root slot
    free: jax.Array  # bool[N] — slot unallocated (allocator free list)


def init_tree(num_actions: int, num_nodes: int, state_dim: int) -> Tree:
    """Fresh single-game tree (root at slot 0, not yet expanded)."""
    A = num_actions
    return Tree(
        visit=jnp.zeros(num_nodes, jnp.int32),
        value_sum=jnp.zeros(num_nodes, jnp.float32),
        parent=jnp.full(num_nodes, UNVISITED, jnp.int32),
        to_play=jnp.zeros(num_nodes, jnp.int32),
        is_terminal=jnp.zeros(num_nodes, bool),
        terminal_value=jnp.zeros(num_nodes, jnp.float32),
        expanded=jnp.zeros(num_nodes, bool),
        prior=jnp.zeros((num_nodes, A), jnp.float32),
        legal=jnp.zeros((num_nodes, A), bool),
        child=jnp.full((num_nodes, A), UNVISITED, jnp.int32),
        child_visit=jnp.zeros((num_nodes, A), jnp.int32),
        child_vsum=jnp.zeros((num_nodes, A), jnp.float32),
        states=jnp.zeros((num_nodes, state_dim), jnp.float32),
        root=jnp.int32(0),
        free=jnp.arange(num_nodes) > 0,
    )


def num_allocated(tree: Tree) -> jax.Array:
    """i32 allocated-node count (the reference's per-game tree-size stat,
    ref ``Training/Gamer.py:42-92``)."""
    return (~tree.free).sum(-1).astype(jnp.int32)

def reroot(tree: Tree, action: jax.Array) -> tuple[Tree, jax.Array]:
    """Re-root a single-game tree at the child reached by ``action``.

    Implements the reference's ``keep_subtree`` option — after a move is
    played, the chosen child's subtree is retained so its statistics seed
    the next move's search (ref ``Training/Gamer.py:78-79`` root swap,
    ``Search/Explorer.py`` subtree reuse;
    ``Configs/Search/Examples/documentation_search_config.yaml``).

    The reference swaps a Python pointer; this does the array equivalent —
    NO compaction, no index remapping:

    1. mark the retained subtree (every node whose ancestor chain contains
       the new root) by pointer-doubling over parent links,
    2. point ``tree.root`` at the chosen child,
    3. return every non-subtree slot to the allocator's free list and zero
       its stats/edges so reuse starts from a clean node.

    Earlier revisions compacted the subtree down to slot 0, which forced a
    full permutation of every table (vmapped gathers → batch-minor layout
    churn on the [N, A] edge stats inside the search loop) plus an O(N)
    select chain PER ELEMENT to remap child ids — quadratic in tree
    capacity and the dominant reroot cost at the reference's 300-800
    simulation budgets.  Keeping ids stable costs one masked pass over
    each table and nothing else, at every capacity.

    Returns ``(new_tree, ok)``; ``ok`` is False when the chosen action has
    no materialized child (possible under epsilon-random/softmax action
    selection), in which case the caller should start the next search from
    a fresh tree.
    """
    from nuzero.ops.gather import CHAIN_LIMIT, pick_at, take_small

    N = tree.visit.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    c = pick_at(take_small(tree.child, tree.root), action)
    ok = c != UNVISITED
    c_safe = jnp.where(ok, c, 0)

    # --- 1. subtree membership by pointer doubling.  Small trees chase
    # parent pointers through exact one-hot f32 matmuls (a vmapped gather
    # pushed batch-minor layouts into the tables on the accelerator this
    # was first built for; not yet measured on the GPU); above the chain
    # limit the [N, N] one-hots outgrow the gather cost and plain gathers
    # win.
    mark = idx == c_safe
    ptr = jnp.where(tree.parent >= 0, tree.parent, idx)
    use_matmul = N <= CHAIN_LIMIT
    for _ in range(max(1, math.ceil(math.log2(max(N, 2))))):
        if use_matmul:
            ptr_oh = (ptr[:, None] == idx[None, :]).astype(jnp.float32)
            mark = mark | (
                jnp.matmul(
                    ptr_oh,
                    mark.astype(jnp.float32),
                    precision=jax.lax.Precision.HIGHEST,
                )
                > 0.5
            )
            ptr = jnp.round(
                jnp.matmul(
                    ptr_oh,
                    ptr.astype(jnp.float32),
                    precision=jax.lax.Precision.HIGHEST,
                )
            ).astype(jnp.int32)
        else:
            mark = mark | mark[ptr]
            ptr = ptr[ptr]

    # --- 2/3. free + clear everything outside the subtree (stale parent
    # chains in freed slots may spuriously mark, so the free list is a
    # UNION with the previous one — a freed slot can never come back
    # except through the allocator).
    free = tree.free | ~mark
    dead_row = free[:, None]
    # Sever the new root's parent link: its old ancestors are freed, and a
    # stale upward pointer into a later-reallocated slot would spuriously
    # re-mark them on a future reroot (slot leak).
    parent = jnp.where(free | (idx == c_safe), UNVISITED, tree.parent)
    new_tree = tree.replace(
        visit=jnp.where(free, 0, tree.visit),
        value_sum=jnp.where(free, 0.0, tree.value_sum),
        parent=parent,
        expanded=jnp.where(free, False, tree.expanded),
        child=jnp.where(dead_row, UNVISITED, tree.child),
        child_visit=jnp.where(dead_row, 0, tree.child_visit),
        child_vsum=jnp.where(dead_row, 0.0, tree.child_vsum),
        root=c_safe,
        free=free,
    )
    return new_tree, ok


def print_tree(tree: Tree, game_idx=None, max_children: int = 8,
               file=None) -> str:
    """Host-side debug dump of one game's array tree (ref the reference's
    recursive ``Explorer.print_tree``, ``Search/Explorer.py:216``).

    ``tree`` is a single-game Tree, or a vmapped batch with ``game_idx``
    selecting the game.  Prints a depth-indented listing of the allocated
    nodes: visits, mean value, prior, terminal flag — and returns it.
    """
    import numpy as np

    if game_idx is not None:
        tree = jax.tree.map(lambda x: x[game_idx], tree)
    visit = np.asarray(tree.visit)
    vsum = np.asarray(tree.value_sum)
    child = np.asarray(tree.child)
    prior = np.asarray(tree.prior)
    to_play = np.asarray(tree.to_play)
    term = np.asarray(tree.is_terminal)
    n_alloc = int((~np.asarray(tree.free)).sum())

    lines = [f"tree: {n_alloc} allocated nodes / {visit.shape[0]} capacity"]

    def rec(node, depth, via_action, via_prior):
        q = vsum[node] / max(int(visit[node]), 1)
        tag = " TERMINAL" if term[node] else ""
        via = f"a={via_action} p={via_prior:.3f} -> " if via_action is not None else ""
        lines.append(
            f"{'  ' * depth}{via}node {node}: n={int(visit[node])} "
            f"q={q:+.3f} to_play={int(to_play[node])}{tag}"
        )
        kids = [
            (int(child[node, a]), a)
            for a in np.flatnonzero(child[node] >= 0)
        ]
        kids.sort(key=lambda ka: -int(visit[ka[0]]))
        for c, a in kids[:max_children]:
            rec(c, depth + 1, a, float(prior[node, a]))
        if len(kids) > max_children:
            lines.append(
                f"{'  ' * (depth + 1)}... {len(kids) - max_children} more "
                "children"
            )

    if n_alloc > 0:
        rec(int(tree.root), 0, None, None)
    out = "\n".join(lines)
    print(out, file=file)
    return out
