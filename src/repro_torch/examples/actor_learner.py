"""Distributed actor–learner RL (paper §5.4, Listings 7/11) — on the
elastic training fabric.

Actors interact with a toy environment and push trajectories into a
registry-advertised replay service; learners sample batches and run a
policy-gradient step with ``torch.autograd`` on their device
(``--device``, the card unless ``cpu`` is asked for). Unlike the original
topology (actors fetch params from the learner over ad-hoc RPC),
everything here rides the fabric's survival story:

  * the learner publishes params to a versioned ModelStore — actors pull
    consistent snapshots and a respawned learner resumes from the last
    published version (step loss <= --publish-every);
  * every worker heartbeats through the Registry; a TrainSupervisor
    respawns whoever dies under RestartPolicy backoff;
  * replay inserts carry a deadline — a dead learner surfaces to actors
    as a typed WriterStalled, and they re-resolve instead of deadlocking.

Environment: 1-D "target chase" — state is (pos, target); reward is
-|pos-target|; actions move ±1/0. Learnable in a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.actor_learner --steps 150
    PYTHONPATH=src python -m repro_torch.examples.actor_learner --actors 4 \
        --learners 2
    PYTHONPATH=src python -m repro_torch.examples.actor_learner \
        --kill-after 2 --device cpu
"""

import tempfile

import numpy as np
import torch

from repro_torch import core as lp
from repro_torch.data.replay import TableConfig
from repro_torch.examples import _cli
from repro_torch.train import fabric
from repro_torch.train.optimizer import OptimizerConfig

GRID = 8
ACTIONS = 3  # left, stay, right
EPISODE_LEN = 16


class ChaseEnv:
    def __init__(self, rng):
        self._rng = rng
        self.reset()

    def reset(self):
        self._pos = int(self._rng.integers(0, GRID))
        self._target = int(self._rng.integers(0, GRID))
        return self._obs()

    def _obs(self):
        return np.array([self._pos, self._target], np.float32) / GRID

    def step(self, action):
        self._pos = int(np.clip(self._pos + (action - 1), 0, GRID - 1))
        reward = -abs(self._pos - self._target) / GRID
        return self._obs(), reward


def policy_logits(params, obs):
    h = torch.tanh(obs @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


class PGTask:
    """Fabric task: REINFORCE on batches of trajectories."""

    optimizer = OptimizerConfig(lr=0.05, warmup_steps=0, total_steps=100_000,
                                weight_decay=0.0, clip_norm=None)

    def init_params(self, seed):
        """Host tensors drawn from a ``torch.Generator`` seeded with
        ``seed``; the learner moves them to its device."""
        gen = torch.Generator().manual_seed(seed)
        return {"w1": torch.randn((2, 32), generator=gen) * 0.5,
                "b1": torch.zeros((32,)),
                "w2": torch.randn((32, ACTIONS), generator=gen) * 0.5,
                "b2": torch.zeros((ACTIONS,))}

    def grad_fn(self, params, batch):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            logits = policy_logits(live, batch["obs"])   # [B, T, A]
            logp = torch.log_softmax(logits, -1)
            chosen = torch.gather(
                logp, -1, batch["act"][..., None].long())[..., 0]
            adv = batch["ret"] - batch["ret"].mean()
            loss = -(chosen * adv).mean()
        grads = torch.autograd.grad(loss, list(live.values()))
        return loss.detach(), dict(zip(live, grads))

    def collate(self, items):
        rew = np.stack([it["rew"] for it in items])
        ret = rew[..., ::-1].cumsum(-1)[..., ::-1].copy()
        return {"obs": np.stack([it["obs"] for it in items]),
                "act": np.stack([it["act"] for it in items]),
                "ret": ret.astype(np.float32)}


def rollout(params, rng):
    """One episode under the current policy -> one replay item. Params are
    host tensors (pulled from the ModelStore), so act with numpy."""
    params = {k: np.asarray(v) for k, v in params.items()}
    env = ChaseEnv(rng)
    obs = env.reset()
    traj_obs, traj_act, traj_rew = [], [], []
    for _ in range(EPISODE_LEN):
        h = np.tanh(obs @ params["w1"] + params["b1"])
        logits = h @ params["w2"] + params["b2"]
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        action = int(rng.choice(ACTIONS, p=probs))
        traj_obs.append(obs)
        traj_act.append(action)
        obs, reward = env.step(action)
        traj_rew.append(reward)
    return {"obs": np.stack(traj_obs), "act": np.array(traj_act),
            "rew": np.array(traj_rew, np.float32)}


class Fleet:
    """PyNode hosting the worker fleet on a ThreadWorkerSpawner, supervised
    by a TrainSupervisor until the chief learner reports done."""

    def __init__(self, registry, store_dir, num_actors, num_learners,
                 cfg: fabric.FabricConfig, device="cuda"):
        self._device = device
        self._registry = registry
        self._store_dir = store_dir
        self._actors = num_actors
        self._learners = num_learners
        self._cfg = cfg

    def run(self):
        spawner = fabric.ThreadWorkerSpawner()
        task = PGTask()
        cfg = self._cfg
        table = TableConfig("trajectories", max_size=2000, sampler="uniform",
                            min_size_to_sample=8)
        resolver = fabric.registry_resolver(self._registry, "replay")

        def spawn_fn(name):
            role, idx = name.rsplit("-", 1)
            if role == "replay":
                spawner.spawn(name, lambda n, ep: fabric.ReplayService(
                    [table], self._registry, name=n, endpoint=ep,
                    heartbeat_s=cfg.heartbeat_s))
            elif role == "learner":
                batch_fn = fabric.replay_batch_fn(
                    resolver, "trajectories", task.collate, cfg.batch_size,
                    cfg.sample_timeout_s)
                spawner.spawn(name, lambda n, ep: fabric.LearnerWorker(
                    task, batch_fn, self._store_dir, self._registry, cfg,
                    name=n, chief=(int(idx) == 0), device=self._device,
                    endpoint=ep))
            elif role == "actor":
                spawner.spawn(name, lambda n, ep, i=int(idx):
                              fabric.ActorWorker(
                                  task, rollout, resolver, "trajectories",
                                  self._store_dir, self._registry, cfg,
                                  name=n, endpoint=ep, seed=100 + i))
            else:
                raise ValueError(name)

        sup = fabric.TrainSupervisor(
            self._registry, spawn_fn,
            expected={"replay": 1, "actor": self._actors,
                      "learner": self._learners},
            policy=lp.RestartPolicy(max_restarts=5, backoff_s=0.05),
            spawn_grace_s=15.0, total_steps=cfg.total_steps)
        try:
            sup.run()
        finally:
            for r in self._registry.lookup()["replicas"]:
                load = r["load"]
                if load.get("role") == "learner" and load.get("chief"):
                    print(f"chief done: step={load['step']} "
                          f"loss={load['loss']:.4f} v={load['version']}")
            spawner.stop_all()


def build(num_actors=4, steps=150, num_learners=1, publish_every=10,
          kill_after=None, ckpt_dir=None, device="cuda") -> lp.Program:
    _cli.checked_device(device)
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="actor_learner_")
    cfg = fabric.FabricConfig(
        total_steps=steps, batch_size=8, publish_every=publish_every,
        peer_timeout_s=10.0, heartbeat_s=0.2, insert_timeout_s=1.0,
        sample_timeout_s=1.0)
    p = lp.Program("actor-learner")
    with p.group("registry"):
        registry = p.add_node(lp.CourierNode(lp.Registry, ttl_s=10.0))
    with p.group("fleet"):
        p.add_node(lp.PyNode(Fleet, registry, ckpt_dir, num_actors,
                             num_learners, cfg, device=device))
    if kill_after is not None:
        with p.group("chaos"):
            p.add_node(lp.PyNode(
                fabric.ChaosNode, registry,
                [("kill", "learner-0", kill_after, 0.0)]))
    return p


def main(argv=None):
    ap = _cli.parser(__doc__.splitlines()[0])
    ap.add_argument("--actors", type=int, default=4)
    ap.add_argument("--learners", type=int, default=1)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--publish-every", type=int, default=10)
    ap.add_argument("--kill-after", type=float, default=None,
                    help="chaos demo: kill the chief learner this many "
                         "seconds after it comes up; the supervisor "
                         "restores it from the last published version")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    if _cli.checked_device(args.device).type == "cpu":
        # Tiny ops from many threads: OpenMP's pool would spin against
        # the GIL (a 20-step run takes ~20x longer).
        torch.set_num_threads(1)
    lp.launch_and_wait(
        build(args.actors, args.steps, num_learners=args.learners,
              publish_every=args.publish_every, kill_after=args.kill_after,
              ckpt_dir=args.ckpt_dir, device=args.device),
        timeout_s=600)


if __name__ == "__main__":
    main()
