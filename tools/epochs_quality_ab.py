"""Training-quality A/B: PPO update_epochs at learner scale.

The update phase scales with the number of epochs, so fewer epochs buy
throughput IF training quality holds.  At 2B rows/update the minibatch
gradient noise is tiny, so the textbook 4 epochs is plausibly overkill.
This A/B trains
vs-the-rule-AI from scratch for each epochs setting (same seed, same env
steps per update) and logs win-rate-vs-env-steps curves.

Output: artifacts/epochs_ab.jsonl (one line per eval point).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from pikazoo_tpu.envs import EnvConfig, PikaZoo
from pikazoo_tpu.train import PPOConfig, make_ppo_trainer
from pikazoo_tpu.train.evaluate import evaluate_vs_computer

EPOCHS = [int(e) for e in os.environ.get("EPOCHS", "4,2,1").split(",")]
UPDATES = int(os.environ.get("UPDATES", 300))
EVAL_EVERY = int(os.environ.get("EVAL_EVERY", 25))
B = int(os.environ.get("PPO_ENVS", 4096))
T = int(os.environ.get("PPO_T", 128))
OUT = os.environ.get("OUT", os.path.join(os.path.dirname(__file__), "..",
                                         "artifacts", "epochs_ab.jsonl"))

env = PikaZoo(EnvConfig(auto_reset=True, is_player2_computer=True))
out = open(OUT, "a")
print(f"[0] epochs={EPOCHS} updates={UPDATES} B={B} T={T}", flush=True)

for epochs in EPOCHS:
    cfg = PPOConfig(num_envs=B, rollout_length=T, update_epochs=epochs,
                    learner_seats="p1")
    init_fn, train_step, network = make_ppo_trainer(env, cfg)
    runner = init_fn(jax.random.key(7))
    step = jax.jit(train_step, donate_argnums=0)
    t_train = 0.0
    for update in range(1, UPDATES + 1):
        t0 = time.perf_counter()
        runner, metrics = step(runner)
        _ = float(metrics.total_loss)  # host sync
        t_train += time.perf_counter() - t0
        if update % EVAL_EVERY == 0 or update == UPDATES:
            r = evaluate_vs_computer(network, runner.params, num_envs=256,
                                     winning_score=5, seed=11)
            rec = {
                "epochs": epochs,
                "update": update,
                "env_steps": update * B * T,
                "win_rate": round(float(r.win_rate), 4),
                "games": int(r.games),
                "score_diff": round(float(r.mean_score_diff), 3),
                "train_s": round(t_train, 2),
            }
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(rec, flush=True)
out.close()
