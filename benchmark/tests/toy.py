"""Toy sizes of each cell for the CPU tests: the cell's own code paths,
the program's plain routes (K1's plain bf16 version on the stage-1
march, as on the card), a few seconds each."""

TOY_FIELD = {"model": {"hidden_dim": 64, "feat_size": 32},
             "rendering": {"ray_marching_steps": 32, "num_points_in": 8,
                           "num_points_out": 4},
             "training": {"n_training_points": 64},
             "dataset_shape": {"hw": [24, 32], "n_lights": 4,
                               "focal_px": 382.0, "cam_dist": 31.5,
                               "light_spread": 0.6}}
TOY_PSNET = {"train": {"num_pixels": 256},
             "dataset_shape": {"hw": [24, 32], "n_lights": 12,
                               "focal_px": 382.0, "cam_dist": 31.5,
                               "light_spread": 0.6, "n_vis_plus": 8}}

OVERRIDES = {
    "s1_train_bear": {"cfg": TOY_FIELD, "runner": {"use_fused_occ": True}},
    "s2_train_bear": {"cfg": TOY_PSNET},
    "s2_eval_bear": {"cfg": TOY_PSNET, "params": {"pick_from": 2,
                                                  "pixels": 64}},
    "s1_export_bear": {"cfg": TOY_FIELD, "runner": {"use_fused_occ": True},
                       "params": {"vis_plus_num": 8, "pixels": 256,
                                  "vis_pixels": 32}},
}


def toy(cell):
    import copy
    return copy.deepcopy(OVERRIDES[cell])
