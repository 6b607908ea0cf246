"""How far two float32 evaluations of the registration's device stages lie
apart, on the Replica fixture of tests/test_replica_fixture.py, and so
which bounds tests/test_torch_registration.py can hold (CPU, one core):

- the pretraining loss at the JAX package's initial parameters and first
  draws: the JAX package jitted, the JAX package eager, the port;
- 20 steps run free from the same initial parameters on the same draws:
  each leaf of the port's against the JAX package's eager run, in units of
  the leaf's largest entry;
- one trained field's uncertainty termination and entropies: each
  package's float32 against a float64 evaluation (the port's modules in
  float64), and the largest metric difference between the packages.

    JAX_PLATFORMS=cpu python tests/torch_registration_spread.py
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import test_torch_registration as T  # noqa: E402


class _TmpFactory:
    def mktemp(self, name):
        return Path(tempfile.mkdtemp(prefix=name))


def main() -> None:
    torch.set_num_threads(1)
    loaded = T.loaded.__wrapped__(_TmpFactory())
    tdata, tinst = loaded["tdata"], loaded["tinst"]
    key = jax.random.PRNGKey(T.PRETRAIN_KEY)
    port = T.tfp.ObjectFieldTrainer(T._objects(tinst), tdata.sample_dict,
                                    tdata.cam, T.Config(),
                                    n_rays=T.PRETRAIN_RAYS, device="cpu")
    lengths = port.lengths.numpy()
    n_obj, max_len = len(lengths), port.packed.shape[0] // len(lengths)
    init_keys, draws = T._jax_draws(key, lengths, T.PRETRAIN_STEPS,
                                    T.PRETRAIN_RAYS)
    init = jax.tree.map(np.asarray,
                        jax.vmap(T.jfp._init_field_params)(init_keys))
    tx, superstep = T._jax_superstep(T.JConfig(), n_obj, max_len,
                                     T.PRETRAIN_RAYS, T.PRETRAIN_STEPS)
    _, k = jax.random.split(jax.random.split(key, n_obj + 1)[0])
    params = jax.tree.map(jnp.asarray, init)
    args = (k, jnp.asarray(port.packed.numpy().reshape(n_obj, max_len, 11)),
            jnp.asarray(lengths, jnp.int32),
            jnp.asarray(port.scales, jnp.float32))
    (_, _), (_, jit_loss, _) = superstep((params, tx.init(params)), *args)
    with jax.disable_jit():
        (eager_params, _), (_, eager_loss, _) = superstep(
            (params, tx.init(params)), *args)

    trainer = T.tfp.ObjectFieldTrainer(
        T._objects(tinst), tdata.sample_dict, tdata.cam, T.Config(),
        n_rays=T.PRETRAIN_RAYS, device="cpu", init=init)
    losses = [float(trainer.step(d)) for d in draws]
    worst = []
    jax.tree.map(
        lambda a, b: worst.append(float(
            np.abs(a - np.asarray(b)).max() / np.abs(np.asarray(b)).max())),
        {"pe": {"B": trainer.pe.B.detach().numpy()},
         "fc": T.tfp.convert.tree_of(trainer.fc)},
        jax.tree.map(np.asarray, eager_params))
    out = {
        "loss_step0": {"jax_jit": float(jit_loss[0]),
                       "jax_eager": float(eager_loss[0]),
                       "port": losses[0]},
        "loss_rel_port_vs_eager": [
            float(abs(a / b - 1.0)) for a, b in zip(losses,
                                                    np.asarray(eager_loss))],
        "leaf_free_run_port_vs_eager_max": max(worst),
    }

    field = trainer.fields()[0]
    obj_id, _, pcs = T._objects(tinst)[0]
    u = torch.tensor(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(obj_id), (10000, T.tunc.N_BINS))))
    rays_o, viewdir, r = T.tunc.shell_rays(field, pcs)
    n = len(rays_o)
    z = T._stratified_from_u(u, torch.zeros(n), torch.full((n,), 2.0 * r))
    pe, fc = T.tunc.field_modules(field, "cpu")
    scale = field["obj_scale"]
    tterm = T.tunc.term_probs_field(
        pe, fc, torch.from_numpy(rays_o), torch.from_numpy(viewdir), z,
        torch.tensor(scale, dtype=torch.float32)).numpy()
    jterm = np.asarray(T.junc._term_probs_field(
        field["pe"], field["fc"], jnp.asarray(rays_o), jnp.asarray(viewdir),
        jnp.asarray(z.numpy()), jnp.float32(scale)))
    t64 = T.tunc.term_probs_field(
        pe.double(), fc.double(), torch.from_numpy(rays_o).double(),
        torch.from_numpy(viewdir).double(), z.double(),
        torch.tensor(scale, dtype=torch.float64)).numpy()

    def ent(t):
        return np.sum(-t * np.log(t + 1e-10), -1)

    def metric(t):
        return 1.0 - T.tunc.calculate_reliability(
            t.sum(-1) * np.exp(-0.5 * ent(t)))

    out["uncertainty"] = {
        "term_port_vs_f64": float(np.abs(tterm - t64).max()),
        "term_jax_vs_f64": float(np.abs(jterm - t64).max()),
        "term_port_vs_jax": float(np.abs(tterm - jterm).max()),
        "entropy_port_vs_f64": float(np.abs(ent(tterm) - ent(t64)).max()),
        "entropy_jax_vs_f64": float(np.abs(ent(jterm) - ent(t64)).max()),
        "metric_port_vs_jax": float(np.abs(metric(tterm)
                                           - metric(jterm)).max()),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
