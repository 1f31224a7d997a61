"""SCS hex-grid wargame as a pure-JAX state machine.

Behavioral target: ``Games/SCS/SCS_Game.py`` — the flagship env: config-
driven scenarios, the 10-stage auto-advancing turn structure (turn-0
placement, then per-player Movement(reinforce, move) and Fighting(choose
target, choose attackers) phases), per-sub-phase action legality, hex
movement with terrain costs, stacking, combat with strongest-unit losses,
reinforcement schedules, and VP-capture termination.

Design decisions:

- The object model (Unit/Tile lists, ref ``Unit.py``/``Tile.py``) becomes
  fixed-capacity arrays: every unit that can ever exist comes from the
  reinforcement schedule, so units live in a flat table indexed by
  ``player * S + schedule_slot``; the board is an ``[R, C, K]`` table of
  unit ids maintaining stacking order (level 0 = bottom).
- ``update_game_env``'s Python while loop (ref ``SCS_Game.py:687-831``)
  becomes a bounded ``lax.while_loop`` whose body switches on the stage.
- Legality (ref ``possible_actions``, ``SCS_Game.py:395-484``) is computed
  for all four sub-phases as dense plane tensors via precomputed neighbor
  tables (no per-unit Python loops) and selected by the current sub-phase.
- ``step`` decodes the flat action into (act, r, c, stacking, direction)
  arithmetically (ref ``parse_action``, ``SCS_Game.py:486-567``) and
  dispatches through ``lax.switch`` over seven total action appliers.
- Strongest-unit combat losses use vectorized lexicographic argmax with
  the reference's first-in-list tie-breaks
  (ref ``SCS_Game.py:1253-1285``).

Deliberate deviation: the framework's static value convention already uses
players {0,1} (the reference's check_termination semantics are unchanged:
+1 = player-0 victory, ref ``SCS_Game.py:857-894``).
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np
from nuzero.utils import struct

from nuzero.envs.base import Env
from nuzero.envs.scs.hexgrid import neighbor_tables
from nuzero.envs.scs.scenario import Scenario

N_STATS = 3  # attack, defense, movement (ref SCS_Game.py:76)
N_STATUSES = 3  # available, moved, attacked (ref SCS_Game.py:75)
N_REINF_SHOWN = 3  # reinforcements represented in the state (ref :202)
SUB_PHASES = 4


# take_small: gather-free small-domain lookup for the unit tables in
# observe/legal (see ops/gather.py).
from nuzero.ops.gather import take_small  # noqa: E402


@struct.dataclass
class SCSState:
    board: jax.Array  # i32[R, C, K] unit ids, -1 empty, level 0 = bottom
    alive: jax.Array  # bool[2S]
    placed: jax.Array  # bool[2S]
    row: jax.Array  # i32[2S]
    col: jax.Array  # i32[2S]
    mov: jax.Array  # f32[2S] movement points left
    status: jax.Array  # i32[2S] 0 avail / 1 moved / 2 attacked
    reinf_next: jax.Array  # i32[2] next schedule slot per player
    turn: jax.Array  # i32
    stage: jax.Array  # i32 in [-2, 7]
    length: jax.Array  # i32
    terminal: jax.Array  # bool
    terminal_value: jax.Array  # f32
    has_target: jax.Array  # bool
    target_row: jax.Array  # i32
    target_col: jax.Array  # i32
    is_attacker: jax.Array  # bool[2S]
    attacker_seq: jax.Array  # i32[2S] selection order, big when unset
    n_attackers: jax.Array  # i32
    vp: jax.Array  # bool[2, R, C] victory-point masks — per-GAME state so
    # randomize_vp can re-draw them each reset (static scenarios carry the
    # load-time masks unchanged)


def _stage_player(stage: jax.Array) -> jax.Array:
    """{-2,0,1,2,3} -> 0; {-1,4,5,6,7} -> 1 (ref SCS_Game.py:783-789)."""
    return jnp.where(
        (stage == -1) | (stage >= 4), jnp.int32(1), jnp.int32(0)
    )


def _stage_sub_phase(stage: jax.Array) -> jax.Array:
    """(ref SCS_Game.py:833-843)."""
    return jnp.where(
        (stage == -2) | (stage == -1) | (stage == 0) | (stage == 4),
        0,
        jnp.where(
            (stage == 1) | (stage == 5),
            1,
            jnp.where((stage == 2) | (stage == 6), 2, 3),
        ),
    ).astype(jnp.int32)


class SCSGame(Env):
    """One instance binds one (scenario, seed) pair, like the reference's
    ``SCS_Game(config_path, seed)`` constructor.

    ``randomize_vp=True`` re-draws each player's victory-point location
    per GAME (uniform over that player's board half) inside ``init(key)``.
    This is the reference's actual training distribution: every self-play
    game constructs a fresh ``SCS_Game`` whose ``load_game_from_config``
    re-randomizes the map (ref ``Training/Gamer.py`` per-game
    construction + ``SCS_Game.py:1570-1777`` Randomized creation), where
    a load-time-only draw would train on ONE fixed layout — measured to
    produce route memorization instead of VP-seeking (a 5x5 solo net
    winning 100% at its training layout transferred 0% to other sizes).
    Supported for scenarios with one VP per player; the VP masks then
    live in the game STATE and ``GoalRushAgent`` (whose Dijkstra field is
    host-precomputed from the static masks) refuses such envs."""

    def __init__(self, scenario: Scenario, randomize_vp: bool = False):
        self.scenario = scenario
        R, C, K = scenario.rows, scenario.cols, scenario.stacking_limit
        self.R, self.C, self.K = R, C, K
        self.S = scenario.units_per_player
        self.U = 2 * self.S  # flat unit table size

        # Action planes (ref SCS_Game.py:147-180).
        self.placement_planes = 1
        self.movement_planes = 6 * K
        self.choose_target_planes = 1
        self.choose_attackers_planes = K
        self.confirm_attack_planes = 1
        self.no_move_planes = K
        self.no_fight_planes = K
        total = (
            self.placement_planes
            + self.movement_planes
            + self.choose_target_planes
            + self.choose_attackers_planes
            + self.confirm_attack_planes
            + self.no_move_planes
            + self.no_fight_planes
        )
        self.placement_limit = self.placement_planes
        self.movement_limit = self.placement_limit + self.movement_planes
        self.target_limit = self.movement_limit + self.choose_target_planes
        self.attackers_limit = self.target_limit + self.choose_attackers_planes
        self.confirm_limit = self.attackers_limit + self.confirm_attack_planes
        self.no_move_limit = self.confirm_limit + self.no_move_planes
        self.no_fight_limit = self.no_move_limit + self.no_fight_planes

        self.num_actions = total * R * C
        self.action_space_shape = (total, R, C)

        # Observation channels (ref SCS_Game.py:186-239).
        self.n_unit_channels = N_STATS * K * N_STATUSES
        self.n_reinf_channels_pp = N_REINF_SHOWN * N_STATS * 2
        channels = (
            3  # terrain
            + 2  # victory points
            + 2 * self.n_reinf_channels_pp
            + 2 * self.n_unit_channels
            + 1  # target tile
            + K  # attackers
            + SUB_PHASES
            + 1  # turn
            + 1  # player
        )
        self.observation_shape = (channels, R, C)
        self.max_game_length = scenario.max_game_length

        # Static device constants.
        self.t_attack = jnp.asarray(scenario.terrain_attack)
        self.t_defense = jnp.asarray(scenario.terrain_defense)
        self.t_cost = jnp.asarray(scenario.terrain_cost)
        self.vp = jnp.asarray(scenario.vp)
        self.n_vp = jnp.asarray(scenario.n_vp, jnp.float32)
        self.randomize_vp = bool(randomize_vp)
        if self.randomize_vp:
            if not np.allclose(np.asarray(scenario.n_vp), 1):
                raise ValueError(
                    "randomize_vp supports scenarios with exactly one "
                    "victory point per player"
                )
            # Per-player draw masks: each player's own board half (the
            # reference's Randomized VP placement range,
            # ref SCS_Game.py load: define_board_sides + own-half cols).
            from nuzero.envs.scs.scenario import board_sides

            p0_last, p1_first = board_sides(C)
            half = np.zeros((2, R, C), bool)
            half[0, :, : p0_last + 1] = True
            half[1, :, p1_first:] = True
            self._vp_half_logits = jnp.asarray(
                np.where(half.reshape(2, R * C), 0.0, -1e9), jnp.float32
            )
        # Flat unit stats [2S].
        self.u_attack = jnp.asarray(scenario.reinf_stats[:, :, 0].reshape(-1))
        self.u_defense = jnp.asarray(scenario.reinf_stats[:, :, 1].reshape(-1))
        self.u_allowance = jnp.asarray(scenario.reinf_stats[:, :, 2].reshape(-1))
        self.u_player = jnp.asarray(
            np.repeat(np.arange(2, dtype=np.int32), self.S)
        )
        self.reinf_turn = jnp.asarray(scenario.reinf_turn)  # [2, S]
        self.reinf_arrival = jnp.asarray(scenario.reinf_arrival)  # [2,S,R,C]
        self.reinf_count = jnp.asarray(scenario.reinf_count)  # [2]
        dst_r, dst_c, valid = neighbor_tables(R, C)
        self.nbr_r = jnp.asarray(dst_r)  # [6, R, C]
        self.nbr_c = jnp.asarray(dst_c)
        self.nbr_ok = jnp.asarray(valid)
        # Cheapest adjacent-tile movement cost per tile (inf where no valid
        # neighbor): lets the move applier's "can this unit still move?"
        # check be one map lookup instead of six dynamic gathers per move
        # (ref consider_other_units=False check, SCS_Game.py:596-600).
        cost_np = np.asarray(scenario.terrain_cost)
        nbr_cost = np.where(valid, cost_np[dst_r, dst_c], np.inf)
        self.min_nbr_cost = jnp.asarray(nbr_cost.min(0), jnp.float32)  # [R,C]
        # Per-direction neighbor cost is a CONSTANT map — precompute it
        # (legal_mask was re-gathering t_cost through the neighbor tables
        # every call).
        self.nbr_cost = jnp.asarray(
            np.where(valid, cost_np[dst_r, dst_c], np.float32(np.inf)),
            jnp.float32,
        )  # [6, R, C]
        # Neighbor reads as matmuls instead of the static-index gather
        # mask[nbr_r, nbr_c]: a static permutation is a one-hot matrix, so
        # neighbor reads become [6*R*C, R*C] @ [R*C] matmuls and the
        # any-neighbor reduction a single [R*C, R*C] @ [R*C].  The
        # operands are 0/1 and small integers, so the products are exact
        # even at reduced matmul precision (checked bit-exact GPU vs CPU
        # by chip_smoke.py).  Whether this beats plain indexing on the GPU
        # is not yet measured (ROADMAP 1.3).
        n_t = R * C
        nbr_mat = np.zeros((6, n_t, n_t), np.float32)
        d_idx = np.arange(6)[:, None, None]
        src_flat = (np.arange(R)[None, :, None] * C
                    + np.arange(C)[None, None, :])
        dst_flat = dst_r * C + dst_c
        for d in range(6):
            for rr in range(R):
                for cc in range(C):
                    if valid[d, rr, cc]:
                        nbr_mat[d, rr * C + cc, dst_flat[d, rr, cc]] = 1.0
        self._nbr_mat = jnp.asarray(nbr_mat.reshape(6 * n_t, n_t))
        self._adj_mat = jnp.asarray(nbr_mat.sum(0))  # [R*C, R*C]
        # Static iotas for masked (gather-free) board updates.
        self._iota_r = jnp.arange(R)[:, None, None]
        self._iota_c = jnp.arange(C)[None, :, None]
        self._iota_k = jnp.arange(K)[None, None, :]
        self._iota_u = jnp.arange(self.U)

    # ------------------------------------------------------------------ #
    # helpers                                                            #
    # ------------------------------------------------------------------ #

    def _stack_count(self, board):
        return (board >= 0).sum(-1).astype(jnp.int32)  # [R, C]

    def _tile_owner(self, board):
        """-1 empty else owning player (all of a tile's units share one
        owner; ref Tile.place_unit/remove_unit)."""
        bottom = board[:, :, 0]
        return jnp.where(bottom >= 0, bottom // self.S, -1).astype(jnp.int32)

    def _unit_gather(self, arr, uid):
        """arr[uid] with -1-safe gather."""
        return arr[jnp.maximum(uid, 0)]

    def _adjacent_any(self, mask):
        """bool[R,C]: tile has any hex neighbor where ``mask`` is True.
        One [R*C, R*C] matmul (see _adj_mat)."""
        flat = mask.reshape(-1).astype(jnp.float32)
        return (self._adj_mat @ flat).reshape(self.R, self.C) > 0

    def _nbr_values(self, x):
        """f32[6, R, C]: each tile's neighbor value per direction (0 where
        no valid neighbor).  One [6*R*C, R*C] matmul (see _nbr_mat)."""
        flat = x.reshape(-1).astype(jnp.float32)
        return (self._nbr_mat @ flat).reshape(6, self.R, self.C)

    def _unit_pos_mask(self, state, cond):
        """bool[R,C]: any unit with cond[uid] True sits on the tile."""
        on = cond & state.placed & state.alive
        m = jnp.zeros((self.R, self.C), jnp.int32)
        m = m.at[state.row, state.col].add(on.astype(jnp.int32))
        return m > 0

    def _ended_reinforcements(self, state, p):
        """(ref player_ended_reinforcements, SCS_Game.py:908-911).
        ``p`` is a Python literal (0/1)."""
        nxt = state.reinf_next[p]
        exhausted = nxt >= self.reinf_count[p]
        slot = jnp.minimum(nxt, self.S - 1)
        return exhausted | (
            take_small(self.reinf_turn[p], slot) != state.turn
        )

    def _no_units_with_status(self, state, p, status):
        mine = (self.u_player == p) & state.placed & state.alive
        return ~jnp.any(mine & (state.status == status))

    # ------------------------------------------------------------------ #
    # Env API                                                            #
    # ------------------------------------------------------------------ #

    def init(self, key=None) -> SCSState:
        # Terrain/unit randomness is bound at load time; the VP masks are
        # re-drawn per game when randomize_vp (see class docstring).
        if self.randomize_vp and key is None:
            # Host-driven callers (viewer, human play, debug renders) that
            # don't thread a key get the one static load-time layout — a
            # different distribution than training sees.  Say so instead
            # of silently showing the fixed layout.
            import warnings

            warnings.warn(
                "SCSGame.init(key=None) with randomize_vp=True uses the "
                "static load-time VP layout, not the randomized training "
                "distribution; pass a PRNG key to sample a layout",
                stacklevel=2,
            )
        if self.randomize_vp and key is not None:
            k0, k1 = jax.random.split(key)
            cells = jnp.stack(
                [
                    jax.random.categorical(k0, self._vp_half_logits[0]),
                    jax.random.categorical(k1, self._vp_half_logits[1]),
                ]
            )
            vp = (
                jax.nn.one_hot(cells, self.R * self.C, dtype=jnp.float32)
                .reshape(2, self.R, self.C)
                .astype(bool)
            )
        else:
            vp = self.vp
        U = self.U
        state = SCSState(
            board=jnp.full((self.R, self.C, self.K), -1, jnp.int32),
            alive=jnp.zeros(U, bool),
            placed=jnp.zeros(U, bool),
            row=jnp.zeros(U, jnp.int32),
            col=jnp.zeros(U, jnp.int32),
            mov=jnp.zeros(U, jnp.float32),
            status=jnp.zeros(U, jnp.int32),
            reinf_next=jnp.zeros(2, jnp.int32),
            turn=jnp.int32(0),
            stage=jnp.int32(-2),
            length=jnp.int32(0),
            terminal=jnp.bool_(False),
            terminal_value=jnp.float32(0.0),
            has_target=jnp.bool_(False),
            target_row=jnp.int32(0),
            target_col=jnp.int32(0),
            is_attacker=jnp.zeros(U, bool),
            attacker_seq=jnp.full(U, 10**6, jnp.int32),
            n_attackers=jnp.int32(0),
            vp=vp,
        )
        return self._update_env(state)

    def current_player(self, state: SCSState) -> jax.Array:
        return _stage_player(state.stage)

    def terminal(self, state: SCSState) -> jax.Array:
        return state.terminal

    def terminal_value(self, state: SCSState) -> jax.Array:
        return state.terminal_value

    # -- legality ------------------------------------------------------- #

    def legal_mask(self, state: SCSState) -> jax.Array:
        R, C, K, S = self.R, self.C, self.K, self.S
        p = self.current_player(state)
        opp = 1 - p
        sub = _stage_sub_phase(state.stage)
        board = state.board
        count = self._stack_count(board)
        owner = self._tile_owner(board)
        status_of = state.status

        # ---- sub-phase 0: placement (ref SCS_Game.py:411-420)
        nxt = jnp.where(p == 0, state.reinf_next[0], state.reinf_next[1])
        cnt = jnp.where(p == 0, self.reinf_count[0], self.reinf_count[1])
        slot = p * S + jnp.minimum(nxt, S - 1)
        have_next = (nxt < cnt) & (
            take_small(self.reinf_turn.reshape(-1), slot) == state.turn
        )
        arrival = take_small(
            self.reinf_arrival.reshape(2 * S, self.R, C), slot
        )
        placement = (
            arrival & ~(owner == opp) & (count < K) & have_next
        )[None]  # [1, R, C]

        # ---- per-level unit info (small-domain lookups, not gathers —
        # see take_small; the unit table has 2S entries)
        lvl_uid = board  # [R, C, K]
        lvl_present = lvl_uid >= 0
        safe = jnp.maximum(lvl_uid, 0)
        lvl_player = safe // S
        lvl_status = take_small(status_of, safe)
        lvl_mov = take_small(state.mov, safe)
        lvl_mine = lvl_present & (lvl_player == p)

        # ---- sub-phase 1: movement + no_move (ref :423-441)
        # All 6 directions x K levels in one stacked computation (the
        # per-direction Python loop was dispatch-bound).
        avail = lvl_mine & (lvl_status == 0)  # [R, C, K]
        dcost = self.nbr_cost  # [6, R, C] constant (inf where invalid)
        dcount = self._nbr_values(count)  # matmul neighbor reads
        downer = self._nbr_values(owner)
        ok = self.nbr_ok & (dcount < K) & (downer != opp)  # [6, R, C]
        can = (
            avail[None]  # [1, R, C, K]
            & ok[:, :, :, None]
            & (lvl_mov[None] - dcost[:, :, :, None] >= 0)
        )  # [6, R, C, K]
        movement = jnp.moveaxis(can, 3, 1).reshape(6 * K, R, C)
        no_move = jnp.moveaxis(avail, -1, 0)  # [K, R, C]

        # ---- sub-phase 2: choose target + no_fight (ref :447-458)
        moved_lvl = lvl_mine & (lvl_status == 1)
        moved_mask = moved_lvl.any(-1)
        enemy_occ = owner == opp
        choose_target = (enemy_occ & self._adjacent_any(moved_mask))[None]
        no_fight = jnp.moveaxis(moved_lvl, -1, 0)  # [K, R, C]

        # ---- sub-phase 3: choose attackers + confirm (ref :463-477)
        target_onehot = (
            (jnp.arange(R)[:, None] == state.target_row)
            & (jnp.arange(C)[None, :] == state.target_col)
            & state.has_target
        )
        adj_target = self._adjacent_any(target_onehot)
        lvl_attacker = take_small(state.is_attacker, safe) & lvl_present
        selectable = (
            lvl_mine
            & (lvl_status != 2)
            & ~lvl_attacker
            & adj_target[:, :, None]
        )
        choose_attackers = jnp.moveaxis(selectable, -1, 0)  # [K, R, C]
        confirm = (target_onehot & (state.n_attackers > 0))[None]

        zeros1 = jnp.zeros((1, R, C), bool)
        zerosK = jnp.zeros((K, R, C), bool)
        zeros6K = jnp.zeros((6 * K, R, C), bool)

        def pick(sub_idx, planes, zeros):
            return jnp.where(sub == sub_idx, planes, zeros)

        mask = jnp.concatenate(
            [
                pick(0, placement, zeros1),
                pick(1, movement, zeros6K),
                pick(2, choose_target, zeros1),
                pick(3, choose_attackers, zerosK),
                pick(3, confirm, zeros1),
                pick(1, no_move, zerosK),
                pick(2, no_fight, zerosK),
            ]
        )
        return (mask & ~state.terminal).reshape(-1)

    # -- stepping -------------------------------------------------------- #

    def step(self, state: SCSState, action: jax.Array) -> SCSState:
        R, C, K = self.R, self.C, self.K
        plane = action // (R * C)
        rc = action % (R * C)
        r, c = rc // C, rc % C

        # Decode (ref parse_action, SCS_Game.py:486-567).
        in_move = (plane >= self.placement_limit) & (plane < self.movement_limit)
        mv_index = jnp.clip(plane - self.placement_limit, 0, 6 * K - 1)
        act = jnp.where(
            plane < self.placement_limit,
            0,
            jnp.where(
                in_move,
                1,
                jnp.where(
                    plane < self.target_limit,
                    2,
                    jnp.where(
                        plane < self.attackers_limit,
                        3,
                        jnp.where(
                            plane < self.confirm_limit,
                            4,
                            jnp.where(plane < self.no_move_limit, 5, 6),
                        ),
                    ),
                ),
            ),
        ).astype(jnp.int32)
        s_lvl = jnp.where(
            in_move,
            mv_index % K,
            jnp.where(
                plane < self.confirm_limit,
                jnp.clip(plane - self.target_limit, 0, K - 1),
                jnp.where(
                    plane < self.no_move_limit,
                    jnp.clip(plane - self.confirm_limit, 0, K - 1),
                    jnp.clip(plane - self.no_move_limit, 0, K - 1),
                ),
            ),
        ).astype(jnp.int32)
        direction = (mv_index // K).astype(jnp.int32)

        operands = (state, r.astype(jnp.int32), c.astype(jnp.int32), s_lvl, direction)
        state = jax.lax.switch(
            act,
            [
                self._act_place,
                self._act_move,
                self._act_choose_target,
                self._act_choose_attacker,
                self._act_confirm,
                self._act_no_move,
                self._act_no_fight,
            ],
            *operands,
        )
        state = state.replace(length=state.length + 1)
        return self._update_env(state)

    # -- action appliers -------------------------------------------------- #

    def _board_push(self, board, r, c, uid):
        """Masked elementwise push (no dynamic-index scatter: the
        full-board where() is one fused elementwise pass over R*C*K
        elements instead of a [K]-row update at a dynamic (r, c))."""
        count = self._stack_count(board)[:, :, None]  # [R, C, 1]
        here = (
            (self._iota_r == r)
            & (self._iota_c == c)
            & (self._iota_k == count)
            & (count < self.K)
        )
        return jnp.where(here, uid, board)

    def _board_remove(self, board, r, c, uid):
        """list.remove semantics: drop uid, shift higher levels down.
        Masked elementwise over the whole board (see _board_push): only
        the (r, c) stack drops uid; every stack is then re-compacted,
        which is the identity for already-compact stacks."""
        here = (self._iota_r == r) & (self._iota_c == c)  # [R, C, 1] bcast
        keep = (board >= 0) & ((board != uid) | ~here)
        rank = jnp.cumsum(keep, axis=-1) - 1  # slot each kept entry lands in
        new = jnp.full_like(board, -1)
        for kp in range(self.K):
            slot = jnp.full(board.shape[:2], -1, board.dtype)
            for j in range(self.K):
                slot = jnp.where(
                    keep[:, :, j] & (rank[:, :, j] == kp), board[:, :, j], slot
                )
            new = new.at[:, :, kp].set(slot)  # static index: no scatter
        return new

    def _unit_set(self, arr, uid, value, do=True):
        """arr.at[uid].set(value) over the [U] unit table, gather-free."""
        hit = (self._iota_u == uid) & do
        return jnp.where(hit, value, arr)

    def _board_at(self, board, r, c, s_lvl):
        """board[r, c, s_lvl] for dynamic scalars, as a small-domain
        lookup over the flattened R*C*K board (see take_small)."""
        flat = board.reshape(-1)
        return take_small(flat, (r * self.C + c) * self.K + s_lvl)

    def _end_movement(self, state, uid):
        """status -> moved; isolated units also end fighting
        (ref end_movement, SCS_Game.py:927-940).

        Gather-free: the enemy-adjacency map is computed once for the whole
        board (static-index neighbor tables) and the unit's tile is read
        with one small-domain lookup instead of per-direction dynamic
        scalar gathers."""
        p = take_small(self.u_player, jnp.maximum(uid, 0))
        enemy_occ = self._tile_owner(state.board) == (1 - p)
        adj_enemy = self._adjacent_any(enemy_occ)  # [R, C]
        ur = take_small(state.row, uid)
        uc = take_small(state.col, uid)
        any_adj_enemy = take_small(adj_enemy.reshape(-1), ur * self.C + uc)
        new_status = jnp.where(any_adj_enemy, 1, 2)
        return state.replace(
            status=self._unit_set(state.status, uid, new_status)
        )

    def _act_place(self, state, r, c, s_lvl, direction):
        """(ref play_action act 0, SCS_Game.py:572-580)."""
        del s_lvl, direction
        p = self.current_player(state)
        slot = jnp.where(p == 0, state.reinf_next[0], state.reinf_next[1])
        uid = p * self.S + jnp.minimum(slot, self.S - 1)
        board = self._board_push(state.board, r, c, uid)
        return state.replace(
            board=board,
            alive=self._unit_set(state.alive, uid, True),
            placed=self._unit_set(state.placed, uid, True),
            row=self._unit_set(state.row, uid, r),
            col=self._unit_set(state.col, uid, c),
            mov=self._unit_set(
                state.mov, uid, take_small(self.u_allowance, uid)
            ),
            status=self._unit_set(state.status, uid, 0),
            reinf_next=state.reinf_next + (jnp.arange(2) == p),
        )

    def _act_move(self, state, r, c, s_lvl, direction):
        """(ref play_action act 1, SCS_Game.py:582-600)."""
        uid = self._board_at(state.board, r, c, s_lvl)
        uid = jnp.maximum(uid, 0)
        rc = r * self.C + c
        dr = take_small(self.nbr_r.reshape(6, -1), direction)
        dr = take_small(dr, rc)
        dc = take_small(self.nbr_c.reshape(6, -1), direction)
        dc = take_small(dc, rc)
        cost = take_small(self.t_cost.reshape(-1), dr * self.C + dc)
        board = self._board_remove(state.board, r, c, uid)
        board = self._board_push(board, dr, dc, uid)
        new_mov = take_small(state.mov, uid) - cost
        state = state.replace(
            board=board,
            row=self._unit_set(state.row, uid, dr),
            col=self._unit_set(state.col, uid, dc),
            mov=self._unit_set(state.mov, uid, new_mov),
        )
        # Auto-end movement when no tile is affordable anymore
        # (consider_other_units=False; ref SCS_Game.py:596-600): one lookup
        # into the precomputed cheapest-neighbor-cost map.
        can_move = (
            new_mov - take_small(self.min_nbr_cost.reshape(-1), dr * self.C + dc)
            >= 0
        )
        ended = self._end_movement(state, uid)
        # Branchless select (a lax.cond whose both sides are cheap masked
        # updates costs more in dispatch than it saves, and vmap would
        # evaluate both branches anyway).
        return jax.tree.map(
            lambda a, b: jnp.where(can_move.reshape((1,) * a.ndim), a, b),
            state,
            ended,
        )

    def _act_choose_target(self, state, r, c, s_lvl, direction):
        del s_lvl, direction
        return state.replace(
            has_target=jnp.bool_(True), target_row=r, target_col=c
        )

    def _act_choose_attacker(self, state, r, c, s_lvl, direction):
        del direction
        uid = jnp.maximum(self._board_at(state.board, r, c, s_lvl), 0)
        return state.replace(
            is_attacker=self._unit_set(state.is_attacker, uid, True),
            attacker_seq=self._unit_set(
                state.attacker_seq, uid, state.n_attackers
            ),
            n_attackers=state.n_attackers + 1,
        )

    def _act_no_move(self, state, r, c, s_lvl, direction):
        del direction
        uid = jnp.maximum(self._board_at(state.board, r, c, s_lvl), 0)
        state = state.replace(status=self._unit_set(state.status, uid, 1))
        # _end_movement re-derives moved/attacked from adjacency:
        return self._end_movement(state, uid)

    def _act_no_fight(self, state, r, c, s_lvl, direction):
        del direction
        uid = jnp.maximum(self._board_at(state.board, r, c, s_lvl), 0)
        return state.replace(status=self._unit_set(state.status, uid, 2))

    @staticmethod
    def _lexi_pick(cand, k1, k2, k3, order):
        """Reference strongest-unit selection: strict-inequality chain over
        list order => max (k1, then k2, then k3), first-in-order ties
        (ref SCS_Game.py:1253-1285)."""
        NEG = jnp.float32(-1e9)
        m1 = cand & (k1 == jnp.where(cand, k1, NEG).max())
        m2 = m1 & (k2 == jnp.where(m1, k2, NEG).max())
        m3 = m2 & (k3 == jnp.where(m2, k3, NEG).max())
        return jnp.argmin(jnp.where(m3, order, 10**8)).astype(jnp.int32)

    def _destroy(self, state, uid, do):
        """(ref destroy_unit, SCS_Game.py:982-995)."""
        removed = self._board_remove(
            state.board,
            take_small(state.row, uid),
            take_small(state.col, uid),
            uid,
        )
        board = jnp.where(do, removed, state.board)
        alive = self._unit_set(
            state.alive, uid, ~do & take_small(state.alive, uid)
        )
        return state.replace(board=board, alive=alive)

    def _act_confirm(self, state, r, c, s_lvl, direction):
        """(ref resolve_combat, SCS_Game.py:997-1027)."""
        del r, c, s_lvl, direction
        tr, tc = state.target_row, state.target_col
        trc = tr * self.C + tc

        # Defenders = units sitting on the target tile — elementwise over
        # the [U] unit table (gather-free; ref iterates the tile's unit
        # list, SCS_Game.py:1000-1005).
        on_target = (
            (state.row == tr) & (state.col == tc) & state.placed & state.alive
        )
        sdef = jnp.where(on_target, self.u_defense, 0.0).sum()
        total_def = sdef * take_small(self.t_defense.reshape(-1), trc)

        # Attack: each attacker's attack x its own tile's modifier.
        att = state.is_attacker & state.alive
        atk_mod = take_small(
            self.t_attack.reshape(-1), state.row * self.C + state.col
        )
        total_att = jnp.where(att, self.u_attack * atk_mod, 0.0).sum()

        # All attackers end fighting BEFORE losses (ref :1016).
        status = jnp.where(att, 2, state.status)
        state = state.replace(status=status)

        defender_losses = total_att >= total_def
        attacker_losses = total_att <= total_def

        # Strongest attacker: (attack, defense, allowance), first-chosen
        # wins ties (selection order).
        a_uid = self._lexi_pick(
            att,
            self.u_attack,
            self.u_defense,
            self.u_allowance,
            state.attacker_seq,
        )
        state = self._destroy(state, a_uid, attacker_losses)

        # Strongest defender: (defense, attack, allowance), stack order.
        # Re-read positions (attacker destruction can't touch the target
        # tile: attackers are adjacent, not on it).  Stack order of unit u
        # is its level in the target stack — derived elementwise from the
        # [K] stack row instead of a scatter over the unit table.
        U = self.U
        stack = take_small(
            state.board.reshape(self.R * self.C, self.K), trc
        )  # [K]
        d_cand = (
            (state.row == tr) & (state.col == tc) & state.placed & state.alive
        )
        stack_order = jnp.full(U, 10**6, jnp.int32)
        for k in range(self.K):
            stack_order = jnp.where(
                (self._iota_u == stack[k]) & (stack[k] >= 0),
                jnp.minimum(stack_order, k),
                stack_order,
            )
        d_uid = self._lexi_pick(
            d_cand,
            self.u_defense,
            self.u_attack,
            self.u_allowance,
            stack_order,
        )
        state = self._destroy(state, d_uid, defender_losses)

        # Clear target + attackers (ref play_action act 4, :615-618).
        return state.replace(
            has_target=jnp.bool_(False),
            is_attacker=jnp.zeros(U, bool),
            attacker_seq=jnp.full(U, 10**6, jnp.int32),
            n_attackers=jnp.int32(0),
        )

    # -- stage machine ----------------------------------------------------- #

    def _new_turn(self, state):
        """(ref new_turn, SCS_Game.py:845-855)."""
        on = state.placed & state.alive
        return state.replace(
            status=jnp.where(on, 0, state.status),
            mov=jnp.where(on, self.u_allowance, state.mov),
        )

    def _termination_value(self, state):
        """(ref check_termination, SCS_Game.py:857-894)."""
        owner = self._tile_owner(state.board)
        # victory_points[p] are player p's OWN locations; captured when the
        # opponent's units sit on them at game end.
        p2_captured = (state.vp[0] & (owner == 1)).sum().astype(jnp.float32)
        p1_captured = (state.vp[1] & (owner == 0)).sum().astype(jnp.float32)
        p1_pct = p1_captured / jnp.maximum(self.n_vp[1], 1.0)
        p2_pct = p2_captured / jnp.maximum(self.n_vp[0], 1.0)
        return jnp.where(
            p1_pct > p2_pct, 1.0, jnp.where(p1_pct < p2_pct, -1.0, 0.0)
        ).astype(jnp.float32)

    def _update_env(self, state: SCSState) -> SCSState:
        """Bounded functional version of the reference's stage-advance loop
        (ref update_game_env, SCS_Game.py:687-831).

        Each iteration computes the seven stage predicates ONCE and derives
        the transition with scalar selects (a lax.switch of per-stage
        closures evaluates every branch under vmap — measured ~10x the op
        count of this form)."""

        def advance(carry):
            s, _ = carry
            stage = s.stage
            er0 = self._ended_reinforcements(s, 0)
            er1 = self._ended_reinforcements(s, 1)
            nm0 = self._no_units_with_status(s, 0, 0)
            nm1 = self._no_units_with_status(s, 1, 0)
            na0 = self._no_units_with_status(s, 0, 1)
            na1 = self._no_units_with_status(s, 1, 1)
            ht = s.has_target

            def at(v):
                return stage == v

            game_over = at(6) & na1 & (s.turn + 1 > self.scenario.turns)
            next_turn = at(6) & na1 & ~game_over

            new_stage = stage
            for cond, tgt in (
                (at(-2) & er0, -1),
                (at(-1) & er1, 0),
                (at(0) & er0, 1),
                (at(1) & nm0, 2),
                (at(2) & na0, 4),
                (at(2) & ~na0 & ht, 3),
                (at(3) & ~ht, 2),
                (at(4) & er1, 5),
                (at(5) & nm1, 6),
                (next_turn, 0),
                (at(6) & ~na1 & ht, 7),
                (at(7) & ~ht, 6),
            ):
                new_stage = jnp.where(cond, tgt, new_stage)
            inc_turn = (at(-1) & er1) | next_turn

            advanced = (new_stage != stage) | inc_turn
            # game_over BREAKS the loop with terminal set (ref :764-766).
            advanced = advanced & ~s.terminal & ~game_over

            s = s.replace(
                stage=new_stage.astype(jnp.int32),
                turn=s.turn + inc_turn.astype(jnp.int32),
            )
            # new_turn reset on turn rollover (ref new_turn, :845-855).
            on = s.placed & s.alive & next_turn
            s = s.replace(
                status=jnp.where(on, 0, s.status),
                mov=jnp.where(on, self.u_allowance, s.mov),
            )
            # Termination value (ref check_termination, :857-894).
            fire = game_over & ~s.terminal
            s = s.replace(
                terminal=s.terminal | game_over,
                terminal_value=jnp.where(
                    fire, self._termination_value(s), s.terminal_value
                ),
            )
            return s, advanced

        state, cont = advance((state, jnp.bool_(True)))
        state, _ = jax.lax.while_loop(
            lambda carry: carry[1], advance, (state, cont)
        )
        return state

    # -- observation ------------------------------------------------------- #

    def observe(self, state: SCSState) -> jax.Array:
        """(ref generate_state, SCS_Game.py:1348-1505); channel order:
        terrain(3), p1_vp, p2_vp, p1_reinf(18), p2_reinf(18), p1_units,
        p2_units, target(1), attackers(K), sub_phase(4), turn(1),
        player(1)."""
        R, C, K, S = self.R, self.C, self.K, self.S
        f = jnp.float32
        chans = [
            self.t_attack[None],
            self.t_defense[None],
            self.t_cost[None],
            state.vp[0][None].astype(f),
            state.vp[1][None].astype(f),
        ]

        # Reinforcements: next N_REINF_SHOWN unplaced units per player,
        # assembled as stacked tensors (per-channel Python loops are
        # dispatch-bound).
        turns_total = jnp.float32(self.scenario.turns + 1)
        for p in range(2):
            idx = state.reinf_next[p] + jnp.arange(N_REINF_SHOWN)
            ok = (idx < self.reinf_count[p]).astype(f)  # [3]
            slot = jnp.minimum(idx, S - 1)
            uid = p * S + slot
            arrival = (
                take_small(self.reinf_arrival[p], slot).astype(f)
                * ok[:, None, None]
            )
            stats = jnp.stack(
                [
                    take_small(self.u_attack, uid),
                    take_small(self.u_defense, uid),
                    take_small(self.u_allowance, uid),
                ],
                axis=1,
            )  # [3, 3stats]
            stats_planes = (
                arrival[:, None] * stats[:, :, None, None]
            )  # [3, 3, R, C]
            turns_left = (
                take_small(self.reinf_turn[p], slot).astype(f)
                - state.turn.astype(f)
            )
            importance = (turns_total - turns_left) / turns_total * ok  # [3]
            dur = jnp.broadcast_to(
                importance[:, None, None, None], (N_REINF_SHOWN, 3, R, C)
            )
            per_unit = jnp.concatenate([stats_planes, dur], axis=1)
            chans.append(per_unit.reshape(N_REINF_SHOWN * 6, R, C))

        # Units by (player, status, stacking level) — one broadcasted
        # one-hot product instead of 2x3xK channel loops.
        lvl_uid = state.board
        present = lvl_uid >= 0
        safe = jnp.maximum(lvl_uid, 0)
        lvl_player = safe // S
        lvl_status = take_small(state.status, safe)
        lvl_stats = jnp.stack(
            [
                take_small(self.u_attack, safe),
                take_small(self.u_defense, safe),
                take_small(state.mov, safe),
            ]
        )  # [3stat, R, C, K]
        pm = lvl_player[None] == jnp.arange(2)[:, None, None, None]  # [2,R,C,K]
        sm = lvl_status[None] == jnp.arange(N_STATUSES)[:, None, None, None]
        m = (present[None, None] & pm[:, None] & sm[None]).astype(f)
        # [2, status, stat, R, C, K] -> [2, status, K, stat, R, C]
        units = m[:, :, None] * lvl_stats[None, None]
        units = jnp.transpose(units, (0, 1, 5, 2, 3, 4))
        chans.append(units.reshape(2 * N_STATUSES * K * N_STATS, R, C))

        target = (
            (jnp.arange(R)[:, None] == state.target_row)
            & (jnp.arange(C)[None, :] == state.target_col)
            & state.has_target
        ).astype(f)
        chans.append(target[None])

        lvl_att = take_small(state.is_attacker, safe) & present
        chans.append(jnp.moveaxis(lvl_att, -1, 0).astype(f))

        sub = _stage_sub_phase(state.stage)
        sub_planes = (jnp.arange(SUB_PHASES)[:, None, None] == sub).astype(f)
        chans.append(jnp.broadcast_to(sub_planes, (SUB_PHASES, R, C)))

        turn_plane = jnp.full(
            (1, R, C), state.turn.astype(f) / jnp.float32(self.scenario.turns), f
        )
        chans.append(turn_plane)

        player_plane = jnp.full(
            (1, R, C),
            jnp.where(self.current_player(state) == 1, -1.0, 1.0),
            f,
        )
        chans.append(player_plane)

        return jnp.concatenate(chans, axis=0)

    # -- artificial probe states ------------------------------------------- #

    def simple_state(self, turn: int, placements) -> SCSState:
        """Build an artificial mid-game state for value probing
        (ref ``set_simple_game_state``, SCS_Game.py:948-978).

        ``placements``: iterable of ``(player, row, col)`` with player in
        {0, 1}.  Each player's units reuse that player's earliest
        reinforcement slots (the reference instead instantiates fresh units
        of a given type id; shipped scenarios use one unit type, so slot
        stats coincide).  All reinforcement-schedule entries arriving at or
        before ``turn`` are cleared, mirroring the reference's
        ``current_reinforcements[...][0..turn].clear()``.  The state is left
        at stage 0 of ``turn`` and auto-advanced, so probes sit at player
        0's movement sub-phase with every placed unit available.

        Host-side constructor — probe sets are built once at startup, so
        this is not jitted.
        """
        placements = list(placements)
        R, C, K, S = self.R, self.C, self.K, self.S
        n_per = [0, 0]
        board = np.full((R, C, K), -1, np.int32)
        row = np.zeros(2 * S, np.int32)
        col = np.zeros(2 * S, np.int32)
        alive = np.zeros(2 * S, bool)
        for p, r, c in placements:
            if p not in (0, 1):
                raise ValueError(f"player must be 0 or 1, got {p}")
            if n_per[p] >= S:
                raise ValueError(
                    f"scenario only has {S} unit slots for player {p}"
                )
            uid = p * S + n_per[p]
            n_per[p] += 1
            lvl = int((board[r, c] >= 0).sum())
            if lvl >= K:
                raise ValueError(f"stacking limit {K} exceeded at ({r},{c})")
            board[r, c, lvl] = uid
            row[uid], col[uid] = r, c
            alive[uid] = True

        reinf_turn = np.asarray(self.reinf_turn)
        reinf_count = np.asarray(self.reinf_count)
        reinf_next = np.zeros(2, np.int32)
        for p in range(2):
            cleared = int(
                ((reinf_turn[p, : reinf_count[p]] <= turn)).sum()
            )
            reinf_next[p] = max(cleared, n_per[p])

        alive_j = jnp.asarray(alive)
        state = SCSState(
            board=jnp.asarray(board),
            alive=alive_j,
            placed=alive_j,
            row=jnp.asarray(row),
            col=jnp.asarray(col),
            mov=jnp.where(alive_j, self.u_allowance, 0.0),
            status=jnp.zeros(2 * S, jnp.int32),
            reinf_next=jnp.asarray(reinf_next),
            turn=jnp.int32(turn),
            stage=jnp.int32(0),
            length=jnp.int32(0),
            terminal=jnp.bool_(False),
            terminal_value=jnp.float32(0.0),
            has_target=jnp.bool_(False),
            target_row=jnp.int32(0),
            target_col=jnp.int32(0),
            is_attacker=jnp.zeros(2 * S, bool),
            attacker_seq=jnp.full(2 * S, 10**6, jnp.int32),
            n_attackers=jnp.int32(0),
            vp=self.vp,
        )
        return self._update_env(state)
