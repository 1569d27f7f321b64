"""The port's command line (counterpart of psnerf_tpu/cli/main.py, same
subcommands and flags):

    python -m psnerf_torch.cli.main <command> ...     (or: psnerf-torch ...)

  stage1-train    <config.yaml>            (stage1/train.py)
  stage1-eval     <config.yaml>            (stage1/eval.py)
  shape-extract   <config.yaml>            (stage1/shape_extract.py)
  extract-mesh    <config.yaml>            (stage1/extract_mesh.py)
  stage2-train    --conf <obj.conf>        (stage2/train.py)
  stage2-eval     --conf <obj.conf>        (stage2/eval.py, incl.
                  --render_envmap / --edit_albedo / --edit_specular)
  evaluation      --data_path ... --test_out_path ...   (evaluation.py)
  chamfer         --mesh_gt --mesh_pred    (chamfer_dist.py)

Every command that builds a runner takes `--device` (default cuda: it
raises where CUDA is missing; `--device cpu` runs on the CPU). `light-avg`,
`convert-ckpt`, `sdps-preprocess`, `--mesh-devices` and `--lpips_weights`
are parsed as the JAX package parses them and raise NotImplementedError:
they are ported with ROADMAP queue 1 items 6 (preprocessing and
conversion), 8 (multi-GPU) and 7 (LPIPS).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

NOT_PORTED = {
    "light-avg": "ROADMAP queue 1 item 6 (preprocessing and conversion)",
    "convert-ckpt": "ROADMAP queue 1 item 6 (preprocessing and conversion)",
    "sdps-preprocess": "ROADMAP queue 1 item 6 (preprocessing and "
                       "conversion)",
    "--mesh-devices": "ROADMAP queue 1 item 8 (multi-GPU)",
    "--lpips_weights": "ROADMAP queue 1 item 7 (LPIPS)",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="psnerf_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def runner_parser(name, **kw):
        p = sub.add_parser(name, **kw)
        p.add_argument("--device", default="cuda",
                       help="torch device of the runner (default cuda; "
                            "cpu runs on the CPU)")
        return p

    p = runner_parser("stage1-train")
    p.add_argument("config")
    p.add_argument("--workdir", default=None)
    p.add_argument("--max-iters", type=int, default=100000)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="data-parallel training over N devices (not "
                        "ported yet: raises)")

    p = runner_parser("stage1-eval")
    p.add_argument("config")
    p.add_argument("--workdir", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--split", default="test")

    p = runner_parser("shape-extract")
    p.add_argument("config")
    p.add_argument("--workdir", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--visibility", action="store_true", default=True)
    p.add_argument("--no-visibility", dest="visibility", action="store_false")
    p.add_argument("--vis_plus", action="store_true")
    p.add_argument("--vis_plus_num", type=int, default=256)

    p = runner_parser("extract-mesh")
    p.add_argument("config")
    p.add_argument("--workdir", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--resolution0", type=int, default=None)
    p.add_argument("--upsampling", type=int, default=None)
    p.add_argument("--mask_carve", action="store_true",
                   help="carve by dilated multi-view silhouettes")
    p.add_argument("--clip_bottom", type=float, default=None)
    p.add_argument("--exterior_only", action="store_true",
                   help="flood-fill enclosed interior pockets before "
                        "marching: extract only the exterior surface")

    p = runner_parser("stage2-train")
    p.add_argument("--conf", required=True)
    p.add_argument("--workdir", default=None)
    p.add_argument("--max-iters", type=int, default=200000)
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="data-parallel training over N devices (not "
                        "ported yet: raises)")

    p = runner_parser("stage2-eval")
    p.add_argument("--conf", required=True)
    p.add_argument("--workdir", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--render_envmap", action="store_true")
    p.add_argument("--envmap_path", default=None)
    p.add_argument("--envmap_scale", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--edit_albedo", action="store_true")
    p.add_argument("--edit_specular", action="store_true")
    p.add_argument("--color", default=None)
    p.add_argument("--basis", type=int, default=None)

    p = sub.add_parser("evaluation")
    p.add_argument("--data_path", required=True)
    p.add_argument("--test_out_path", required=True)
    p.add_argument("--inten_normalize", default=None)
    p.add_argument("--lpips_weights", default=None)

    p = sub.add_parser("chamfer")
    p.add_argument("--mesh_gt", required=True)
    p.add_argument("--mesh_pred", required=True)
    p.add_argument("--num_samples", type=int, default=10000)

    p = sub.add_parser("light-avg")
    p.add_argument("--obj", required=True, help="dataset directory")
    p.add_argument("--intnorm", action="store_true")

    p = sub.add_parser("convert-ckpt",
                       help="reference torch checkpoint -> npz (not ported "
                            "yet: raises)")
    p.add_argument("--stage", choices=["stage1", "stage2", "lcnet", "nenet"],
                   required=True)
    p.add_argument("--model", required=True, help="torch .pt/.pth[.tar] path")
    p.add_argument("--lights", default=None,
                   help="stage2 LightParameters .pth (optional)")
    p.add_argument("--out", required=True, help="output .npz path")

    p = sub.add_parser("sdps-preprocess",
                       help="run SDPS-Net (LCNet+NENet) over a dataset (not "
                            "ported yet: raises)")
    p.add_argument("--obj", required=True, help="dataset directory")
    p.add_argument("--lcnet", required=True, help="converted or torch ckpt")
    p.add_argument("--nenet", required=True)
    p.add_argument("--train_light", type=int, default=None)
    p.add_argument("--intnorm_gt", action="store_true")
    return parser


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to psnerf_torch yet: "
                              f"{NOT_PORTED[what]}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    cmd = args.cmd
    if cmd in ("light-avg", "convert-ckpt", "sdps-preprocess"):
        _not_ported(cmd)
    if getattr(args, "mesh_devices", None):
        _not_ported("--mesh-devices")

    if cmd in ("stage1-train", "stage1-eval", "shape-extract", "extract-mesh"):
        from psnerf_torch.config import stage1_config_from_yaml
        from psnerf_torch.runners.stage1 import Stage1Runner

        cfg = stage1_config_from_yaml(args.config)
        workdir = args.workdir or cfg.out_dir
        runner = Stage1Runner(cfg, workdir,
                              resume=not getattr(args, "no_resume", False),
                              device=args.device)
        if cmd == "stage1-train":
            runner.train(args.max_iters)
        elif cmd == "stage1-eval":
            out = args.out or os.path.join(workdir, "eval")
            metrics = runner.eval_views(out, args.split)
            print(json.dumps(metrics, indent=2))
        elif cmd == "shape-extract":
            out = args.out or os.path.join(workdir, "shape_out")
            runner.shape_extract(out, visibility=args.visibility,
                                 vis_plus=args.vis_plus,
                                 vis_plus_num=args.vis_plus_num)
            print(f"exports written to {out}")
        else:
            out = args.out or os.path.join(workdir, "mesh.ply")
            verts, tris = runner.extract_mesh_to(
                out, args.resolution0, args.upsampling,
                mask_carve=args.mask_carve, clip_bottom=args.clip_bottom,
                exterior_only=args.exterior_only)
            print(f"mesh: {len(verts)} verts, {len(tris)} tris -> {out}")

    elif cmd in ("stage2-train", "stage2-eval"):
        from psnerf_torch.config import stage2_config_from_conf
        from psnerf_torch.data.envmap import load_envmap
        from psnerf_torch.runners.stage2 import Stage2Runner

        cfg = stage2_config_from_conf(args.conf)
        workdir = args.workdir or os.path.join("out2", cfg.obj_name,
                                               cfg.expname)
        runner = Stage2Runner(cfg, workdir, device=args.device)
        if cmd == "stage2-train":
            runner.train(args.max_iters, plot_every=cfg.plot_freq)
        else:
            out = args.out or os.path.join(workdir, "test_out")
            if args.render_envmap:
                env = load_envmap(args.envmap_path)
                runner.render_envmap(out, env, gamma=args.gamma,
                                     envmap_scale=args.envmap_scale)
            elif args.edit_albedo or args.edit_specular:
                albedo_new = None
                if args.edit_albedo:
                    c = args.color or "#804020"
                    albedo_new = np.asarray(
                        [int(c.lstrip("#")[i:i + 2], 16) for i in (0, 2, 4)],
                        np.float32) / 255.0
                basis_new = args.basis if args.edit_specular else None
                runner.edit_material(out, albedo_new=albedo_new,
                                     basis_new=basis_new)
            else:
                runner.evaluate(out)
            print(f"outputs written to {out}")

    elif cmd == "evaluation":
        from psnerf_torch.eval.evaluation import evaluate_outputs

        if args.lpips_weights:
            _not_ported("--lpips_weights")
        res = evaluate_outputs(args.data_path, args.test_out_path,
                               args.inten_normalize)
        print(json.dumps(res, indent=2))

    elif cmd == "chamfer":
        from psnerf_torch.mesh.chamfer import chamfer_distance
        from psnerf_torch.mesh.meshio import load_mesh

        vg, tg = load_mesh(args.mesh_gt)
        vp, tp = load_mesh(args.mesh_pred)
        cd = chamfer_distance(vp, tp, vg, tg, args.num_samples)
        print(f"Chamfer Distance (mm):  {cd * 1000:.2f}")


if __name__ == "__main__":
    main()
