"""OC20 S2EF training configs: the port's own copy of the JAX package's
configs/oc20.py (``config``, ``config_debug``, ``config_synthetic``;
reference configs/OC20/oc20_config_corrected.py, the paper's S2EF-2M
EquiformerV2 hyperparameters and the OCP label normalization).

``config`` is the full model: 12 layers, 128 channels, lmax 6 / mmax 2, 8
heads, FFN 512, 600 RBF, cutoff 12 with 20 neighbours, batches of 16, loss
E-MSE x 2 + F-L1 x 100, AdamW lr 4e-4 on a warmup + cosine schedule, EMA
0.999.  Every config builds the factored Wigner representation (kernel K4
on the card), which is what the JAX package's ``wigner_rep="auto"`` resolves
to off a TPU.  The run directories are the port's own (``runs/oc20_torch*``):
the port never writes a run directory of the JAX package.
``config_synthetic`` trains a small model on ``data/synthetic.py``'s
periodic LJ crystals and needs no dataset on disk.
"""

config = {
    # data
    "data_path": "datasets/OC20/s2ef_train_2M",
    "val_path": "datasets/OC20/s2ef_val_id",
    "batch_size": 16,
    # model (reference equiformerv2_oc20.py defaults / paper S2EF-2M)
    "num_layers": 12,
    "sphere_channels": 128,
    "attn_hidden_channels": 128,
    "num_heads": 8,
    "attn_alpha_channels": 32,
    "attn_value_channels": 16,
    "ffn_hidden_channels": 512,
    "lmax": 6,
    "mmax": 2,
    "edge_channels": 128,
    "num_rbf": 600,
    "max_num_elements": 90,
    "cutoff": 12.0,
    "max_neighbors": 20,
    "alpha_drop": 0.1,
    "drop_path_rate": 0.05,
    "avg_num_nodes": 77.81317,
    "avg_degree": 23.395238876342773,
    "wigner_rep": "factored",
    "conv_fused": False,
    # loss (reference train_oc20v2: E-MSE*2 + F-L1*100)
    "w_energy": 2.0,
    "w_force": 100.0,
    # normalization (reference data_loader_oc20v2.py:21-24)
    "energy_mean": -0.7554450631141663,
    "energy_std": 2.887317180633545,
    # optimization (per-step cosine+warmup, EMA 0.999)
    "lr": 4e-4,
    "weight_decay": 1e-3,
    "epochs": 3,
    "warmup_steps": 100,
    "grad_clip": 1.0,
    "ema_decay": 0.999,
    # run
    "run_dir": "runs/oc20_torch",
    "seed": 0,
    "log_every": 50,
    "ckpt_every_epochs": 1,
}

config_debug = {
    **config,
    "num_layers": 2,
    "lmax": 3,
    "batch_size": 4,
    "epochs": 1,
    "run_dir": "runs/oc20_torch_debug",
}

# dataset-free integration config: a small model on synthetic LJ crystals
config_synthetic = {
    **config,
    "synthetic": True,
    "n_samples": 16,
    "n_atoms": 6,
    "num_layers": 2,
    "sphere_channels": 16,
    "attn_hidden_channels": 16,
    "num_heads": 2,
    "attn_alpha_channels": 4,
    "attn_value_channels": 4,
    "ffn_hidden_channels": 32,
    "lmax": 2,
    "mmax": 1,
    "edge_channels": 16,
    "num_rbf": 32,
    "max_num_elements": 32,
    "cutoff": 5.0,
    "max_neighbors": 12,
    "alpha_drop": 0.0,
    "drop_path_rate": 0.0,
    "avg_num_nodes": 6.0,
    "avg_degree": 5.0,
    "batch_size": 4,
    "epochs": 2,
    "warmup_steps": 5,
    "log_every": 10,
    "run_dir": "runs/oc20_torch_synthetic",
}
