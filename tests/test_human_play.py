"""Human-vs-agent terminal loop with scripted input
(ref ``Tester.ttt_vs_agent``, ``Testing/Tester.py:123-156``)."""

import numpy as np

from nuzero.envs import TicTacToe
from nuzero.evaluation import RandomAgent, play_vs_agent


class ScriptedInput:
    """Feeds canned answers; falls back to the first legal action parsed
    from the prompt once the script runs out."""

    def __init__(self, answers):
        self.answers = list(answers)
        self.prompts = []

    def __call__(self, prompt):
        self.prompts.append(prompt)
        if self.answers:
            return self.answers.pop(0)
        legal = prompt.split("legal: [")[1].split("]")[0].split(",")
        return legal[0].strip()


def test_game_runs_to_terminal_and_rejects_illegal():
    env = TicTacToe()
    lines = []
    inp = ScriptedInput(["banana", "99", "4"])  # two illegal, then center
    value = play_vs_agent(
        env,
        RandomAgent(),
        human_player=0,
        seed=3,
        input_fn=inp,
        print_fn=lines.append,
    )
    out = "\n".join(str(x) for x in lines)
    assert out.count("illegal move") >= 2
    assert "game over" in out
    assert value in (-1.0, 0.0, 1.0)


def test_coordinate_input_accepted():
    env = TicTacToe()
    lines = []
    # "1 1" = center via (row, col) coords -> plane 0 ravel
    inp = ScriptedInput(["1 1"])
    play_vs_agent(
        env, RandomAgent(), human_player=0, seed=5, input_fn=inp, print_fn=lines.append
    )
    assert any("game over" in str(x) for x in lines)
