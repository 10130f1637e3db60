"""The port's data-preparation scripts, checked without running a model.

`scripts/*_torch.sh` run the steps of `scripts/get_base_data.sh`,
`prepare_training_data.sh` and `prepare_pseudo_thetas.sh` through `python
-m tepose_tpu_torch...`. Each `python -m` line names a port module whose
parser accepts the line's flags in a process where jax, tepose_tpu, joblib
and h5py cannot be imported (the GPU host has none of them), every module
that takes `--gpu` is given it, and each script is its original line for
line once the tools' paths are mapped to the port's modules and the
`--gpu` pass-through is taken out.
"""

import json
import os
import re
import shlex
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("get_base_data", "prepare_training_data", "prepare_pseudo_thetas")

# each shell variable of the scripts' python lines, as the shell gives it
SHELL_VALUES = {"SRC": "downloads", "OUT": "data/base_data", "g": "male",
                "up": "MALE", "v": "vibe_w_3dpw", "name": "insta_train",
                "GPU": "0"}

# parse a module's argv and stop: the parser's namespace, or its exit code
PARSE_ONLY = r"""
import argparse, json, runpy, sys
for name in ("jax", "tepose_tpu", "joblib", "h5py"):
    sys.modules[name] = None

class Parsed(Exception):
    pass

def parse_args(self, args=None, namespace=None):
    raise Parsed(sorted(vars(parse(self, args, namespace))))

parse = argparse.ArgumentParser.parse_args
argparse.ArgumentParser.parse_args = parse_args
out = []
for module, argv in json.loads(sys.argv[1]):
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except Parsed as e:
        out.append(e.args[0])
    except SystemExit as e:
        out.append(f"exit {e.code}")
print(json.dumps(out))
"""


def _lines(name: str):
    """The script's commands, continuation lines joined, comments out."""
    with open(os.path.join(REPO, "scripts", name)) as f:
        text = f.read().replace("\\\n", " ")
    return [" ".join(s.split()) for s in text.splitlines()
            if s.strip() and not s.lstrip().startswith("#")]


def _as_original(line: str) -> str:
    """A port script's line as its original spells it."""
    line = line.replace(' --gpu "$GPU"', "")
    line = re.sub(r"python -m tepose_tpu_torch\.preprocess\.(\w+)",
                  r"python tools/preprocess/\1.py", line)
    return re.sub(r"python -m tepose_tpu_torch\.(\w+)",
                  r"python tools/\1.py", line)


def _python_calls(lines):
    """(module, argv) of every `python -m` line, shell variables given
    their `SHELL_VALUES`."""
    calls = []
    for line in lines:
        at = line.find("python -m ")
        if at < 0:
            continue
        words = shlex.split(re.sub(r"\$\{?(\w+)\}?",
                                   lambda m: SHELL_VALUES[m.group(1)],
                                   line[at:]))
        end = words.index(";") if ";" in words else len(words)
        calls.append((words[2], words[3:end]))
    return calls


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_runs_the_originals_steps_in_order(script):
    port = _lines(f"{script}_torch.sh")
    original = _lines(f"{script}.sh")
    assert [_as_original(s) for s in port
            if s != "GPU=${TEPOSE_GPU:-0}"] == original
    assert not any("tools/" in s or "tepose_tpu." in s for s in port)
    assert os.access(os.path.join(REPO, "scripts", f"{script}_torch.sh"),
                     os.X_OK)


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_modules_parse_their_flags_without_jax(script):
    calls = _python_calls(_lines(f"{script}_torch.sh"))
    assert calls and all(m.startswith("tepose_tpu_torch.") for m, _ in calls)
    proc = subprocess.run(
        [sys.executable, "-c", PARSE_ONLY, json.dumps(calls)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    parsed = json.loads(proc.stdout.strip().splitlines()[-1])
    for (module, argv), dests in zip(calls, parsed):
        assert isinstance(dests, list), (module, argv, dests, proc.stderr)
        # a module that takes --gpu is given it: it runs on the card
        assert ("gpu" in dests) == ("--gpu" in argv), (module, argv)
