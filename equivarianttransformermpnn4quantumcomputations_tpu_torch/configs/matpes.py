"""MatPES training configs: the port's own copy of the JAX package's
configs/matpes.py and of the ``synthetic`` config of its
train/train_matpes.py.

``config`` is the production step: the flagship GATA-V2 model (6 layers,
128 channels, lmax 4 / mmax 2, S2 grid 18), batches of 16, AdamW
(lr 2e-4, weight decay 1e-3) on a warmup + cosine schedule, bf16 compute
with f32 master weights.  The ablations ``config_no_attn_norm`` and
``config_phi_every_layer`` change one model option each;
``config_baseline_efv2`` is the original EquiformerV2 (no GATA) with stress
regression.  ``synthetic`` and ``config_synthetic_convergence`` train on
``data/synthetic.py:SyntheticCrystals`` and need no dataset on disk;
``config_fixture`` trains on the MatPES-format fixture in
``tests/fixtures/train/`` and writes ``runs/matpes_fixture_torch`` (the
JAX package's committed ``runs/matpes_fixture`` stays untouched).
"""

config = {
    # data
    "data_path": "datasets/MatPES/MatPES-PBE-2025.1.json.gz",
    "split_path": "datasets/MatPES/MatPES-PBE-split.json.gz",
    "cache_dir": "datasets/MatPES/cache",
    "batch_size": 16,
    "max_train": None,
    "max_val": None,
    "max_test": None,
    # model (reference equiformerv2_MatPES_GATAV2.py defaults)
    "gata": True,
    "num_layers": 6,
    "sphere_channels": 128,
    "attn_hidden_channels": 128,
    "num_heads": 8,
    "attn_alpha_channels": 32,
    "attn_value_channels": 16,
    "ffn_hidden_channels": 512,
    "lmax": 4,
    "mmax": 2,
    "grid_resolution": 18,
    "edge_channels": 128,
    "num_rbf": 600,
    "max_num_elements": 100,
    "cutoff": 6.0,
    "max_neighbors": 20,
    "alpha_drop": 0.05,
    "drop_path_rate": 0.05,
    "avg_degree": 12.0,
    "normalize_attn_output": True,
    "use_phi_every_layer": False,
    "conv_fused": False,             # kernel K3 at the full SO(2)-conv site (conv 2)
    "wigner_rep": "dense",           # kernel K1; "factored": kernel K4
    # loss weights (reference train_MatPES_GATAWandB.py:79-81)
    "w_energy": 1.0,
    "w_force": 1.0,
    "w_stress": 0.0,
    "regress_stress": False,
    # optimization
    "lr": 2e-4,
    "weight_decay": 1e-3,
    "epochs": 100,
    "warmup_epochs": 1,
    "grad_clip": 1.0,
    "ema_decay": 0.999,
    # run
    "run_dir": "runs/matpes_gata",
    "seed": 0,
    "log_every": 50,
    "ckpt_every_epochs": 1,
    "use_wandb": False,
    "scan_layers": False,
    # rematerialize each block / the whole energy evaluation in the force
    # step's backwards (nn/remat.py): less memory, a longer step
    "remat": False,
    "inner_ckpt": False,
    "mixed_precision": True,
}

config_debug = {
    **config,
    "max_train": 256,
    "max_val": 64,
    "max_test": 64,
    "epochs": 2,
    "num_layers": 2,
    "batch_size": 8,
    "run_dir": "runs/matpes_debug",
    "scan_layers": True,
    "mixed_precision": False,
}

# the JAX CLI's --config synthetic (train/train_matpes.py:120-127)
synthetic = {
    **config_debug,
    "synthetic": True,
    "max_train": 48,
    "max_val": 16,
    "cutoff": 5.0,
    "run_dir": "runs/matpes_synthetic",
}


# ablation: no attention-output normalization
# (reference equiformerv2_MatPES_GATAV2_no_normalize_attn_output.py)
config_no_attn_norm = {**config, "normalize_attn_output": False}

# phi refined at every layer
# (reference equiformerv2_MatPES_GATAV2_phi_at_every_iteration_like_gata.py)
config_phi_every_layer = {**config, "use_phi_every_layer": True}

# baseline (non-GATA) EquiformerV2 on MatPES with stress
# (reference equiformerv2_MatPES.py / train_MatPES_originalEFV2_WandB.py)
config_baseline_efv2 = {**config, "gata": False, "regress_stress": True, "w_stress": 0.1}

# synthetic-LJ train-to-convergence (the JAX package's PARITY_NUMERICS.md run)
config_synthetic_convergence = {
    **config,
    "synthetic": True,
    "max_train": 512,
    "max_val": 64,
    "cutoff": 5.0,
    "num_layers": 4,
    "num_rbf": 128,
    "batch_size": 32,
    "epochs": 200,
    "warmup_epochs": 10,
    "eval_every": 5,
    "ckpt_every_epochs": 20,
    "lr": 3e-4,
    "alpha_drop": 0.0,
    "drop_path_rate": 0.0,
    "run_dir": "runs/matpes_synth_convergence_torch",
    "scan_layers": True,
    "mixed_precision": False,
}

# fixture-scale MatPES-format training (scripts/make_fixture_train_data.py)
config_fixture = {
    **config,
    "data_path": "tests/fixtures/train/matpes_train.json.gz",
    "split_path": "tests/fixtures/train/matpes_split_train.json.gz",
    "cache_dir": None,
    "batch_size": 8,
    "num_layers": 2,
    "sphere_channels": 32,
    "attn_hidden_channels": 32,
    "num_heads": 4,
    "attn_alpha_channels": 8,
    "attn_value_channels": 8,
    "ffn_hidden_channels": 64,
    "lmax": 2,
    "mmax": 1,
    "grid_resolution": None,
    "edge_channels": 32,
    "num_rbf": 64,
    "cutoff": 5.0,
    "max_neighbors": 12,
    "alpha_drop": 0.0,
    "drop_path_rate": 0.0,
    "epochs": 80,
    "warmup_epochs": 4,
    "eval_every": 5,
    "lr": 1e-3,
    "weight_decay": 0.0,
    "run_dir": "runs/matpes_fixture_torch",
    "scan_layers": True,
    "mixed_precision": False,
}
