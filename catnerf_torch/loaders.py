"""Scene construction for the CLI: a copy of the JAX package's
`loaders.py`.

One entry for "give me a trainable scene": a reference-layout dataset from
a config JSON, or the built-in synthetic analytic scene (no data needed).
Parity target: the dataset-construction prologue of the reference driver
(ref: train.py:30-48, src/dataset.py:16-24); the synthetic branch has no
reference equivalent.
"""

from __future__ import annotations


def load_scene(config: str | None, synthetic: bool = False,
               strict_parity: bool = False, device=None):
    """(cfg, inst_dict, sample_dict, cam) for a config file or the built-in
    synthetic scene. strict_parity applies Config.apply_strict_parity()
    BEFORE dataset construction (registration flags act inside the dataset
    ctor). device: where the registration's device stages run (the card
    unless named)."""
    from catnerf_torch.config import Config
    from catnerf_torch.data.camera import CameraInfo

    if not synthetic and config is None:
        raise SystemExit("one of --config or --synthetic is required")
    if synthetic:
        from catnerf_torch.data.synthetic import make_scene

        cfg = Config()
        cfg.net_hyperparams.latent_dim = 32
        if strict_parity:
            cfg.apply_strict_parity()
        scene = make_scene(n_frames=8, width=160, height=120,
                           n_categories=3, insts_per_cat=2, seed=cfg.seed)
        return cfg, scene.inst_dict, scene.sample_dict, scene.cam

    cfg = Config.from_json(config)
    if strict_parity:
        cfg.apply_strict_parity()
    from catnerf_torch.data.replica import get_dataset

    data = get_dataset(cfg, device=device)
    return cfg, data.inst_dict, data.sample_dict, CameraInfo.from_config(cfg)
