"""Human-vs-agent terminal play (ref ``Tester.ttt_vs_agent``,
``Testing/Tester.py:123-156``).

Works for any env: the human types an action index (or ``row col`` /
``plane row col`` coordinates), illegal inputs re-prompt with the legal
list, and the opponent is any evaluation :class:`Agent`.  ``input_fn`` /
``print_fn`` are injectable for tests.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nuzero.evaluation.agents import Agent


def _render(env, state, print_fn):
    if hasattr(env, "render"):
        print_fn(env.render(state))
    else:
        from nuzero.utils.render import render_scs_ascii

        print_fn(render_scs_ascii(env, state))


def _parse_action(env, text: str) -> Optional[int]:
    parts = text.split()
    try:
        nums = [int(x) for x in parts]
    except ValueError:
        return None
    if len(nums) == 1:
        return nums[0]
    if hasattr(env, "action_space_shape") and len(nums) == len(env.action_space_shape):
        return int(np.ravel_multi_index(tuple(nums), env.action_space_shape))
    if hasattr(env, "action_space_shape") and len(nums) == len(env.action_space_shape) - 1:
        # allow "row col" for single-plane games like TTT
        return int(np.ravel_multi_index((0, *nums), env.action_space_shape))
    return None


def play_vs_agent(
    env,
    agent: Agent,
    human_player: int = 0,
    seed: int = 0,
    input_fn: Callable[[str], str] = input,
    print_fn: Callable[[str], None] = print,
) -> float:
    """Play one game in the terminal; returns the terminal value
    (+1 = player 0 wins, -1 = player 1, 0 = draw)."""
    step = jax.jit(env.step)
    variables = getattr(agent, "variables", None)
    rng = jax.random.key(seed)
    state = env.init(None)
    moves = 0

    while not bool(env.terminal(state)):
        player = int(env.current_player(state))
        _render(env, state, print_fn)
        legal = np.flatnonzero(np.asarray(env.legal_mask(state)).reshape(-1))
        if player == human_player:
            while True:
                text = input_fn(
                    f"[P{player}] action index or coords (legal: {legal.tolist()}): "
                )
                a = _parse_action(env, text.strip())
                if a is not None and a in legal:
                    break
                print_fn(f"illegal move {text!r} — try again")
        else:
            rng, sub = jax.random.split(rng)
            # Cache-aware host decision (the wired consumer of the
            # inference-cache subsystem; ref Gamer/Tester cache use).
            a = agent.choose_host(env, state, variables, sub, moves)
            print_fn(f"[{agent.name}] plays {a}")
        state = step(state, int(a))
        moves += 1

    _render(env, state, print_fn)
    value = float(env.terminal_value(state))
    outcome = {1.0: "player 0 wins", -1.0: "player 1 wins"}.get(value, "draw")
    print_fn(f"game over: {outcome} (value {value:+.1f})")
    return value
