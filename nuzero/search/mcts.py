"""Fully-batched MCTS (PUCT) over array trees.

Behavioral target: ``Search/Explorer.py`` — same UCT formula, root noise,
and action-selection rules — redesigned for an accelerator:

- B games search simultaneously; each simulation's leaf states across the
  batch are evaluated in ONE batched network call (the reference runs
  batch-1 inference per leaf per game — ``Explorer.py:151`` — the single
  biggest throughput loss its design imposes).
- Descent/backprop are ``lax.while_loop``s vmapped over games; the tree is
  pure data (see ``tree.py``), simulations are a ``lax.fori_loop``.

Faithfulness notes (deliberate deviations documented):

- PUCT score (ref ``Explorer.py:114-130``):
  ``prior * sqrt(N_parent)/(1+N_child) * c + value_factor * q`` with
  ``c = log((N_parent + pb_c_base + 1)/pb_c_base) + pb_c_init``.
  The value term is negated for player 1's decisions.  The reference's
  negation keys on ``to_play == 2`` which matched Tic-Tac-Toe's {1,2}
  labels but never fired for SCS's {0,1} (``Explorer.py:124``); with the
  framework-wide {0,1} convention the flip is always correct.  This
  *changes SCS search behavior* vs the reference, intentionally (SURVEY §2.3
  hazard note).
- Backpropagation adds the absolute (player-0 perspective) value along the
  whole path with no sign alternation (ref ``Explorer.py:132-135``).
- Root exploration noise is multiplicative-mix gamma noise on the priors —
  NOT normalized Dirichlet (ref ``Explorer.py:201-210``).
- The root is evaluated/expanded as the search's first simulation and
  backed up once, exactly what the reference's first simulation does to a
  fresh root (``Explorer.py:49-61``); noise is applied after root expansion
  (the reference applies it before the loop, which is a no-op for fresh
  roots and only bites with subtree reuse).
- Terminal leaves re-contribute their terminal value on every visit
  (ref ``Explorer.py:140-142``).
- If the network puts zero mass on all legal moves, priors fall back to
  uniform-over-legal (ref ``Explorer.py:171-174``).
- Argmax tie-breaking: the reference's ``max()`` over (score, action,
  child) tuples breaks score ties toward the *largest* action index;
  ``jnp.argmax`` breaks toward the smallest.  Ties are measure-zero with
  float scores; not reproduced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from nuzero.utils import struct

from nuzero.ops.gather import pick_at, take_small
from nuzero.search.tree import Tree, init_tree

NEG_INF = jnp.float32(-1e9)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static search configuration (ref search-config YAML schema,
    ``Configs/Search/Examples/documentation_search_config.yaml``)."""

    num_simulations: int = 100
    keep_subtree: bool = True
    pb_c_base: float = 10000.0
    pb_c_init: float = 1.15
    number_of_softmax_moves: int = 0
    epsilon_softmax_exploration: float = 0.04
    epsilon_random_exploration: float = 0.001
    value_factor: float = 1.0
    root_exploration_fraction: float = 0.2
    root_dist_alpha: float = 0.15
    root_dist_beta: float = 1.0
    # Node budget for trees carried across moves (keep_subtree).  0 = auto:
    # 2*num_simulations + 4, enough for a retained subtree plus one search's
    # new allocations (carried roots run one extra simulation — see
    # make_search_fn).  Unlike the reference's unbounded Python trees, the
    # array tree is a fixed budget: when full, simulations stop expanding
    # and re-contribute leaf evaluations (documented deviation; the search
    # warns through SearchResults.tree_nodes when the cap binds).
    # SCALING: above SCATTER_CREDIT_MIN_NODES backprop switches from the
    # dense one-hot einsum to path scatter-adds whose per-simulation cost
    # is bounded by MAX_PATH_DEPTH — independent of capacity.  How the
    # 300-800 simulation budgets scale on the GPU is not yet measured
    # (benchmarks/sims_scaling_bench.py; ROADMAP 2.1).
    tree_capacity: int = 0


@struct.dataclass
class SearchResults:
    action: jax.Array  # i32[B] chosen action
    policy_target: jax.Array  # f32[B, A] root child visits, normalized
    root_value: jax.Array  # f32[B] root mean value (static convention)
    root_visits: jax.Array  # i32[B]
    tree_nodes: jax.Array  # i32[B] allocated node count (stats parity:
    # ref Gamer.py:42-92 per-game tree-size stats)
    exploration_bias: jax.Array  # f32[B] final root bias (ref Explorer.py:63)
    children_per_node: jax.Array  # f32[B] avg materialized children per
    # allocated node (ref Gamer.py:42-92 "average children" per-game stat)
    depth_capped: jax.Array  # f32[B] fraction of simulations whose descent
    # hit MAX_PATH_DEPTH (0 everywhere observed; nonzero = raise the cap)


def _masked_priors(logits: jax.Array, legal: jax.Array) -> jax.Array:
    """softmax over ALL logits, mask, renormalize; uniform-over-legal
    fallback (ref ``Explorer.py:159-174``)."""
    p = jax.nn.softmax(logits, axis=-1) * legal
    total = p.sum(axis=-1, keepdims=True)
    n_legal = legal.sum(axis=-1, keepdims=True)
    uniform = legal / jnp.maximum(n_legal, 1)
    return jnp.where(total > 0, p / jnp.where(total > 0, total, 1.0), uniform)


def _exploration_bias(parent_visit, params: SearchParams):
    return (
        jnp.log((parent_visit + params.pb_c_base + 1.0) / params.pb_c_base)
        + params.pb_c_init
    )


def _puct_scores(tree: Tree, node: jax.Array, params: SearchParams):
    """f32[A] selection scores at ``node`` for a single-game tree.

    Reads the DENSE per-edge stats (``tree.child_visit``/``child_vsum``)
    — contiguous row slices.  The obvious alternative (gather each child
    node's stats through ``tree.child[node]``) is an [A]-wide gather,
    which the accelerator this was first built for executed serially.
    Per-node SCALAR reads go through take_small (a [N]-chain of selects)
    for the same reason.  Which wins on the GPU is not yet measured
    (ROADMAP 1.3, 1.4)."""
    parent_visit = take_small(tree.visit, node).astype(jnp.float32)
    c = _exploration_bias(parent_visit, params)
    child_visit = tree.child_visit[node].astype(jnp.float32)  # f32[A]
    child_vsum = tree.child_vsum[node]  # f32[A]
    q = jnp.where(child_visit > 0, child_vsum / jnp.maximum(child_visit, 1.0), 0.0)
    # Static values: +1 good for player 0.  Negate for player 1's choice.
    sign = jnp.where(take_small(tree.to_play, node) == 1, -1.0, 1.0)
    u = tree.prior[node] * jnp.sqrt(parent_visit) / (1.0 + child_visit) * c
    score = u + params.value_factor * sign * q
    return jnp.where(tree.legal[node], score, NEG_INF)


def _descend(tree: Tree, params: SearchParams, depth_cap: int):
    """Walk from the root to a frontier (pure row slices over the packed
    tree — no env work).  Single-game.  Returns
    (stop_node, sel_action, needs_alloc, path, path_actions).

    ``path`` is an i32[depth_cap] buffer of the visited node indices
    (unused slots hold ``num_nodes``, an out-of-bounds sentinel) so that
    backprop becomes one scatter-add instead of a second walk — the
    leaf->root pointer chase of the reference (``Explorer.py:132-135``)
    costs a sequential loop iteration per edge, while a recorded path
    costs one ``.at[].add`` with dropped out-of-bounds rows.
    ``path_actions[i]`` is the action selected at ``path[i]`` (backprop
    credits the dense edge stats along these (node, action) pairs)."""
    num_nodes = tree.visit.shape[0]

    def cond(carry):
        _, _, stop, _, _, depth = carry
        # depth_cap bounds the walk (and with it the recorded-path credit
        # buffers) independently of tree capacity; a capped descent
        # re-contributes the frontier node's evaluation, like a full tree.
        return ~stop & (depth < depth_cap)

    iota_depth = jnp.arange(depth_cap)

    root = tree.root

    def body(carry):
        node, _, _, path, acts, depth = carry
        # Masked writes/reads, not scalar DUS/gathers — each of those is
        # a serialized custom call, and this body runs ~depth times per
        # simulation (see _puct_scores note).
        path = jnp.where(iota_depth == depth, node, path)
        can_continue = take_small(tree.expanded, node) & ~take_small(
            tree.is_terminal, node
        )
        scores = _puct_scores(tree, node, params)
        action = jnp.argmax(scores).astype(jnp.int32)
        action = jnp.where(can_continue, action, 0)
        acts = jnp.where(iota_depth == depth, action, acts)
        child = pick_at(tree.child[node], action)
        # Cases: (a) node unexpanded/terminal -> stop here, no alloc;
        #        (b) chosen child missing -> stop, alloc;
        #        (c) chosen child exists -> continue from child.
        follow = can_continue & (child != -1)
        nxt = jnp.where(follow, child, node)
        return nxt, action, ~follow, path, acts, depth + 1

    path0 = jnp.full((depth_cap,), num_nodes, jnp.int32)
    acts0 = jnp.zeros((depth_cap,), jnp.int32)
    node, action, stopped, path, acts, depth = jax.lax.while_loop(
        cond,
        body,
        (
            root,
            jnp.int32(0),
            jnp.bool_(False),
            path0,
            acts0,
            jnp.int32(0),
        ),
    )
    # A depth-capped exit (~stopped) re-contributes the frontier node's
    # evaluation without allocating: its path slot was never recorded, so
    # an allocation there would receive edge credit with no node credit.
    capped = ~stopped
    needs_alloc = (
        take_small(tree.expanded, node)
        & ~take_small(tree.is_terminal, node)
        & (pick_at(tree.child[node], action) == -1)
        & ~capped
    )
    return node, action, needs_alloc, path, acts, capped


#: Tree capacities past which backprop credits stats with scatter-adds
#: over the recorded path instead of the dense one-hot einsum.  The einsum
#: streams the full [N, A] tables every simulation (O(N*A) memory
#: traffic per simulation -> quadratic total cost in the simulation
#: budget); the scatter touches only B*(path) elements — constant per
#: simulation — but its adds are atomics on the GPU, so value sums may
#: differ in the last bits from run to run.  The threshold was tuned on
#: the accelerator this was first built for and is not yet measured on
#: the GPU (benchmarks/sims_scaling_bench.py; ROADMAP 3.1).
SCATTER_CREDIT_MIN_NODES = 1024

#: Descent/credit path cap: descents stop and re-contribute the frontier
#: node's evaluation past this depth, bounding the recorded-path buffers
#: (and with them the per-simulation credit cost) independently of tree
#: capacity.  PUCT trees at the reference's 300-800 simulation budgets
#: stay far shallower than this on every workload observed so far; the
#: search surfaces `depth_capped` when it ever binds.
MAX_PATH_DEPTH = 64


def _backprop_path(
    tree: Tree,
    path: jax.Array,
    path_actions: jax.Array,
    stop_node: jax.Array,
    sel_action: jax.Array,
    leaf: jax.Array,
    value: jax.Array,
    fresh: jax.Array,
    active: jax.Array,
) -> Tree:
    """Add ``value`` and a visit to every node on the recorded root->stop
    path plus a freshly-allocated leaf (ref Explorer.py:132-135, absolute
    value, no sign alternation).  Single-game, one scatter.

    When no node was allocated the stop node is already the last path
    entry, so the leaf slot is pointed out of bounds to avoid double
    counting.  ``active=False`` drops the whole simulation (used to give
    carried roots their extra masked simulation).

    The dense per-edge stats (``child_visit``/``child_vsum`` — see
    ``tree.py``) receive the same credit along every *descended* edge:
    consecutive valid path entries (path[i] --path_actions[i]--> path[i+1])
    plus, for fresh allocations, the (stop_node, sel_action) -> leaf edge.

    Two credit lowering strategies (crossover at
    ``SCATTER_CREDIT_MIN_NODES``):

    - small trees: a one-hot outer-product einsum — a matmul-shaped
      [P, N] x [P, A] contraction added densely into the tables,
    - large trees: scatter-adds over the recorded (node, action) pairs —
      per-simulation cost proportional to the path length, independent of
      tree capacity, which keeps the reference's 300-800 simulation
      budgets scaling ~linearly instead of quadratically."""
    num_nodes = tree.visit.shape[0]
    A = tree.prior.shape[-1]
    use_scatter = num_nodes >= SCATTER_CREDIT_MIN_NODES
    extra = jnp.where(fresh, leaf, jnp.int32(num_nodes))
    nodes = jnp.concatenate([path, extra[None]])
    nodes = jnp.where(active, nodes, num_nodes)

    # Edge credit sources.  Intra-path edges: source path[i] is valid iff
    # its target path[i+1] is a real node.  Leaf edge: the stop node (last
    # valid path entry) -> freshly allocated leaf via sel_action.
    path_live = jnp.where(active, path, num_nodes)
    tgt_valid = path_live[1:] < num_nodes
    src = jnp.where(tgt_valid, path_live[:-1], num_nodes)  # [P-1]
    stop_src = jnp.where(fresh & active, stop_node, jnp.int32(num_nodes))
    src_all = jnp.concatenate([src, stop_src[None]])
    act_all = jnp.concatenate([path_actions[:-1], sel_action[None]])

    if use_scatter:
        # Sentinel (out-of-bounds) rows are dropped by the scatter.
        visit = tree.visit.at[nodes].add(1, mode="drop")
        vsum = tree.value_sum.at[nodes].add(value, mode="drop")
        child_visit = tree.child_visit.at[src_all, act_all].add(
            1, mode="drop"
        )
        child_vsum = tree.child_vsum.at[src_all, act_all].add(
            value, mode="drop"
        )
    else:
        # Dense one-hot accumulation: sentinel rows vanish, the [P+1, N]
        # reduction is one elementwise pass, and the [P,N]x[P,A] edge
        # contraction is a matmul with exact bf16 one-hot operands and
        # f32 accumulation.
        counts = jax.nn.one_hot(nodes, num_nodes, dtype=jnp.float32).sum(
            axis=0
        )
        visit = tree.visit + counts.astype(jnp.int32)
        vsum = tree.value_sum + value * counts
        src_oh = jax.nn.one_hot(
            src_all, num_nodes, dtype=jnp.bfloat16
        )  # [P, N]
        act_oh = jax.nn.one_hot(act_all, A, dtype=jnp.bfloat16)  # [P, A]
        edge = jnp.einsum(
            "pn,pa->na", src_oh, act_oh, preferred_element_type=jnp.float32
        )
        child_visit = tree.child_visit + edge.astype(jnp.int32)
        child_vsum = tree.child_vsum + value * edge
    return tree.replace(
        visit=visit,
        value_sum=vsum,
        child_visit=child_visit,
        child_vsum=child_vsum,
    )


def make_search_fn(
    env,
    apply_fn: Callable[[Any, jax.Array], Tuple[jax.Array, jax.Array]],
    params: SearchParams,
    training: bool,
    with_tree: bool = False,
):
    """Build the batched search function.

    ``apply_fn(variables, obs[B,C,H,W]) -> (logits[B,A], value[B])`` is the
    batched network (recurrent iteration count already bound).
    ``states`` is a batch-B env-state pytree for the games' current
    positions.

    - ``with_tree=False``:
      ``search(variables, states, game_lengths, rng) -> SearchResults``;
      one fresh tree per move.
    - ``with_tree=True`` (subtree reuse, ref ``keep_subtree``):
      ``search(variables, states, game_lengths, rng, tree, carried)
      -> (SearchResults, Tree)``.  ``tree`` is the batch of trees already
      re-rooted at the current positions (``tree.reroot``); ``carried`` is
      bool[B] — games where it's False start from a fresh root.  The
      returned tree feeds the next move's ``reroot``.
    """
    A = env.num_actions
    if with_tree:
        num_nodes = params.tree_capacity or (2 * params.num_simulations + 4)
    else:
        num_nodes = params.num_simulations + 1
    depth_cap = min(num_nodes - 1, env.max_game_length, MAX_PATH_DEPTH) + 1

    from nuzero.utils.packing import make_packer

    _template = env.init(jax.random.key(0))
    pack, unpack, state_dim = make_packer(_template)

    def evaluate_batch(variables, states_b):
        obs = jax.vmap(env.observe)(states_b)
        logits, value = apply_fn(variables, obs)
        legal = jax.vmap(env.legal_mask)(states_b)
        priors = _masked_priors(logits, legal)
        is_term = jax.vmap(env.terminal)(states_b)
        term_val = jax.vmap(env.terminal_value)(states_b)
        value = jnp.where(is_term, term_val, value)
        return priors, legal, value, is_term, term_val

    def search(variables, states, game_lengths, rng, tree=None, carried=None):
        B = jax.tree.leaves(states)[0].shape[0]
        fresh_tree = jax.vmap(lambda _: init_tree(A, num_nodes, state_dim))(
            jnp.arange(B)
        )
        fresh_tree = fresh_tree.replace(
            states=fresh_tree.states.at[:, 0].set(jax.vmap(pack)(states))
        )

        # --- Root evaluation == the reference's first simulation on a
        # fresh root (expand + one backup), batched across games.
        priors0, legal0, value0, term0, tval0 = evaluate_batch(variables, states)
        # ONE gamma draw serves both the fresh and the carried root: each
        # game applies noise to exactly one of them (selected by
        # ``carried``), and the rejection-sampling gamma while-loop is
        # costly enough to matter at two draws per move.
        noise = None
        if training:
            rng, sub = jax.random.split(rng)
            noise = (
                jax.random.gamma(sub, params.root_dist_alpha, (B, A))
                * params.root_dist_beta
            )
        if training:
            frac = params.root_exploration_fraction
            noisy = priors0 * (1.0 - frac) + noise * frac
            # Only legal actions have children in the reference
            # (Explorer.py:207-210 iterates node.children).
            priors0 = jnp.where(legal0, noisy, 0.0)
        to_play0 = jax.vmap(env.current_player)(states)
        fresh_tree = fresh_tree.replace(
            prior=fresh_tree.prior.at[:, 0].set(priors0),
            legal=fresh_tree.legal.at[:, 0].set(legal0),
            expanded=fresh_tree.expanded.at[:, 0].set(~term0),
            to_play=fresh_tree.to_play.at[:, 0].set(to_play0),
            is_terminal=fresh_tree.is_terminal.at[:, 0].set(term0),
            terminal_value=fresh_tree.terminal_value.at[:, 0].set(tval0),
            visit=fresh_tree.visit.at[:, 0].set(1),
            value_sum=fresh_tree.value_sum.at[:, 0].set(value0),
        )

        if with_tree and tree is not None:
            # Keep the carried subtree where valid, else the fresh root.
            def sel(c_arr, f_arr):
                cond = carried.reshape((B,) + (1,) * (c_arr.ndim - 1))
                return jnp.where(cond, c_arr, f_arr)

            tree = jax.tree.map(sel, tree, fresh_tree)
            if training:
                # Noise the reused root's stored priors once, now that it
                # has become root — matching Explorer.py's
                # add_exploration_noise on an already-expanded root
                # (Explorer.py:46,201-210).  Each node becomes root at most
                # once (the keep_subtree swap advances every move), so no
                # compounding occurs in either implementation.  Reuses the
                # single per-move gamma draw (see above) — a game is either
                # fresh or carried, never both.
                frac = params.root_exploration_fraction
                # The carried root lives at a per-game slot (tree.root) —
                # read/write its row with masked passes, not gathers.
                root_row = (
                    jnp.arange(num_nodes)[None, :] == tree.root[:, None]
                )  # [B, N]
                root_prior = (
                    jnp.where(root_row[..., None], tree.prior, 0.0).sum(1)
                )
                root_legal = (
                    jnp.where(root_row[..., None], tree.legal, False).any(1)
                )
                noisy = jnp.where(
                    root_legal,
                    root_prior * (1.0 - frac) + noise * frac,
                    0.0,
                )
                write = root_row[..., None] & carried[:, None, None]
                tree = tree.replace(
                    prior=jnp.where(write, noisy[:, None, :], tree.prior)
                )
        else:
            tree = fresh_tree

        # --- Remaining descents.  Fresh roots already spent their first
        # simulation on the root evaluation above, so they run
        # num_simulations - 1 more; carried roots were expanded on an
        # EARLIER move, so — like the reference, which always runs all
        # num_simulations descents on an already-expanded root
        # (Explorer.py:49-58) — they get one extra masked iteration.
        if with_tree and carried is not None:
            extra_active = carried
            n_iters = params.num_simulations
        else:
            extra_active = jnp.zeros((B,), bool)
            n_iters = params.num_simulations - 1

        def sim_body(i, carry):
            tree, capped_count = carry
            active = jnp.where(
                i < params.num_simulations - 1,
                jnp.ones((B,), bool),
                extra_active,
            )
            stop_node, action, needs_alloc, path, path_acts, capped = (
                jax.vmap(lambda t: _descend(t, params, depth_cap))(tree)
            )
            # Full trees (possible only with carried subtrees) stop
            # expanding and just re-contribute the stop node's evaluation.
            any_free = tree.free.any(-1)
            first_free = jnp.argmax(tree.free, axis=-1).astype(jnp.int32)
            needs_alloc = needs_alloc & active & any_free

            # Allocate (masked): step the stop node's stored state once.
            stop_state = jax.vmap(lambda t, i: unpack(t.states[i]))(
                tree, stop_node
            )
            stepped = jax.vmap(env.step)(stop_state, action)
            leaf_state = jax.tree.map(
                lambda new, old: jnp.where(
                    needs_alloc.reshape((B,) + (1,) * (old.ndim - 1)),
                    new,
                    old,
                ),
                stepped,
                stop_state,
            )
            new_idx = jnp.where(needs_alloc, first_free, jnp.int32(0))

            def write_alloc(t, idx, park_ok, pnode, act, packed, do):
                child = t.child.at[pnode, act].set(
                    jnp.where(do, idx, pick_at(t.child[pnode], act))
                )
                parent = t.parent.at[idx].set(
                    jnp.where(do, pnode, take_small(t.parent, idx))
                )
                # Masked-out games park the write in the first free slot
                # (overwritten by the next real allocation); with no free
                # slot the index is out of bounds and the scatter drops it.
                park = jnp.where(park_ok, idx, jnp.int32(num_nodes))
                states = t.states.at[jnp.where(do, idx, park)].set(packed)
                free = t.free & ~(
                    (jnp.arange(num_nodes) == idx) & do
                )
                return t.replace(
                    child=child,
                    parent=parent,
                    states=states,
                    free=free,
                )

            tree = jax.vmap(write_alloc)(
                tree,
                jnp.where(any_free, first_free, jnp.int32(num_nodes)),
                any_free,
                stop_node,
                action,
                jax.vmap(pack)(leaf_state),
                needs_alloc,
            )
            leaf = jnp.where(needs_alloc, new_idx, stop_node)

            # Evaluate all leaves in ONE batched network call.
            priors, legal, value, is_term, tval = evaluate_batch(
                variables, leaf_state
            )
            to_play = jax.vmap(env.current_player)(leaf_state)

            def write_eval(t, i, pr, lg, tp, te, tv, fresh):
                # Freshly-allocated leaves get their metadata + expansion;
                # revisited terminal leaves just contribute value again.
                wr = fresh
                return t.replace(
                    prior=t.prior.at[i].set(jnp.where(wr, pr, t.prior[i])),
                    legal=t.legal.at[i].set(jnp.where(wr, lg, t.legal[i])),
                    expanded=t.expanded.at[i].set(
                        jnp.where(wr, ~te, t.expanded[i])
                    ),
                    to_play=t.to_play.at[i].set(jnp.where(wr, tp, t.to_play[i])),
                    is_terminal=t.is_terminal.at[i].set(
                        jnp.where(wr, te, t.is_terminal[i])
                    ),
                    terminal_value=t.terminal_value.at[i].set(
                        jnp.where(wr, tv, t.terminal_value[i])
                    ),
                )

            tree = jax.vmap(write_eval)(
                tree, leaf, priors, legal, to_play, is_term, tval, needs_alloc
            )
            # Revisited terminal leaves: value must be their terminal value.
            value = jnp.where(
                jax.vmap(lambda t, i: take_small(t.is_terminal, i))(tree, leaf),
                jax.vmap(lambda t, i: take_small(t.terminal_value, i))(
                    tree, leaf
                ),
                value,
            )
            tree = jax.vmap(_backprop_path)(
                tree, path, path_acts, stop_node, action, leaf, value,
                needs_alloc, active,
            )
            return tree, capped_count + (capped & active).astype(jnp.int32)

        tree, capped_count = jax.lax.fori_loop(
            0, n_iters, sim_body, (tree, jnp.zeros((B,), jnp.int32))
        )

        # --- Policy target: normalized root-child visit counts
        # (ref tic_tac_toe.py:177-182 store_search_statistics).  Read from
        # the dense edge stats — zero where no child was materialized.
        # The root is a per-game slot: one masked pass per [N, A] table,
        # once per MOVE (not per simulation — negligible).
        root_row = (
            jnp.arange(num_nodes)[None, :] == tree.root[:, None]
        )  # [B, N]
        child_visits = (
            jnp.where(root_row[..., None], tree.child_visit, 0)
            .sum(1)
            .astype(jnp.float32)
        )
        visit_sum = child_visits.sum(axis=-1, keepdims=True)
        policy_target = child_visits / jnp.maximum(visit_sum, 1.0)

        # --- Action selection (ref Explorer.py:70-97).
        rng, k_soft, k_eps, k_rand, k_pick = jax.random.split(rng, 5)
        legal_root = jnp.where(root_row[..., None], tree.legal, False).any(1)
        if training:
            soft_logits = jnp.where(legal_root, child_visits, NEG_INF)
            softmax_pick = jax.random.categorical(k_soft, soft_logits, axis=-1)
            rand_logits = jnp.where(legal_root, 0.0, NEG_INF)
            random_pick = jax.random.categorical(k_rand, rand_logits, axis=-1)
            argmax_pick = jnp.argmax(
                jnp.where(legal_root, child_visits, -1.0), axis=-1
            )
            eps = jax.random.uniform(k_eps, (B, 2))
            action = jnp.where(
                eps[:, 0] < params.epsilon_softmax_exploration,
                softmax_pick,
                jnp.where(
                    eps[:, 1] < params.epsilon_random_exploration,
                    random_pick,
                    argmax_pick,
                ),
            )
            action = jnp.where(
                game_lengths < params.number_of_softmax_moves,
                softmax_pick,
                action,
            )
        else:
            action = jnp.argmax(
                jnp.where(legal_root, child_visits, -1.0), axis=-1
            )
        action = action.astype(jnp.int32)

        root_visits = jnp.where(root_row, tree.visit, 0).sum(-1)
        root_value = jnp.where(root_row, tree.value_sum, 0.0).sum(
            -1
        ) / jnp.maximum(root_visits.astype(jnp.float32), 1.0)
        # Avg materialized children per allocated node (one [B, N]
        # reduction per MOVE, not per simulation — negligible).
        alloc = ~tree.free
        n_alloc = alloc.sum(-1).astype(jnp.int32)
        n_children = ((tree.child != -1).sum(-1) * alloc).sum(-1)
        children_per_node = n_children / jnp.maximum(
            n_alloc.astype(jnp.float32), 1.0
        )
        results = SearchResults(
            action=action,
            policy_target=policy_target,
            root_value=root_value,
            root_visits=root_visits,
            tree_nodes=n_alloc,
            exploration_bias=_exploration_bias(
                root_visits.astype(jnp.float32), params
            ),
            children_per_node=children_per_node,
            depth_capped=capped_count.astype(jnp.float32)
            / max(n_iters, 1),
        )
        if with_tree:
            return results, tree
        return results

    return search
