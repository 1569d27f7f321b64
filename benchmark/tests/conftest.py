"""Toy sizes of the cells whose overrides toy.py does not list, registered
in toy.OVERRIDES before the tests are collected."""

import toy

TOY_SDPS = {"dataset_shape": {"hw": [26, 34], "n_lights": 4,
                              "focal_px": 382.0, "cam_dist": 31.5,
                              "light_spread": 0.6},
            "lcnet": {"test_hw": [64, 64]}}

toy.OVERRIDES.update({
    "s0_sdps_bear": {"cfg": TOY_SDPS, "params": {"pick_from": 2}},
    "s2_relight_bear": {"cfg": toy.TOY_PSNET,
                        "params": {"pick_from": 2, "pixels": 64,
                                   "light_h": 4, "tile": 256}},
})
