"""`chip_smoke.py` is reproducible from its --seed: the processor's word
tokenizer maps words through Python's str hash, which is salted per process
unless PYTHONHASHSEED is set, so the script runs itself again with
PYTHONHASHSEED = --seed. Without that, every run prompted the model with
other token ids (the masks' foreground ranged 0.22-0.63 over runs of one
tree on the card, and the route comparisons that follow failed in some)."""
import os
import subprocess
import sys

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = ("from rga3_tpu_torch.data.processor import WordTokenizer; "
       "print(WordTokenizer().convert_tokens_to_ids('person'))")


def _ids(hash_seed):
    env = {**os.environ, "PYTHONHASHSEED": hash_seed, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-c", IDS], env=env, cwd=ROOT, check=True,
                          capture_output=True, text=True).stdout.strip()


def test_token_ids_follow_the_hash_seed():
    assert _ids("1") == _ids("1") != _ids("2")


def test_chip_smoke_runs_again_under_its_seed():
    env = chip_smoke.hash_seed_env(3, {"HOME": "/h"})
    assert env == {"HOME": "/h", "PYTHONHASHSEED": "3"}
    assert chip_smoke.hash_seed_env(3, env) is None
    assert chip_smoke.hash_seed_env(0, env) == {"HOME": "/h", "PYTHONHASHSEED": "0"}
