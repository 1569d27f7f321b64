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
  light-avg       --obj <dir> [--intnorm]  (light_avg.py)
  convert-ckpt    --stage stage1|stage2|lcnet|nenet --model <.pth[.tar]>
                  [--lights <.pth>] --out <.npz>
  sdps-preprocess --obj <dir> --lcnet <ckpt> --nenet <ckpt>
                  (preprocessing/test.py; a converted .npz or a torch
                  checkpoint for each net)

From a raw dataset: sdps-preprocess -> light-avg --obj <dir> (and the
SDPS-normalized images, preprocess.light_avg.light_average(intnorm=True,
sdps=True)) -> stage1-train -> shape-extract -> stage2-train ->
stage2-eval -> evaluation.

Every command that runs on the card takes `--device` (default cuda: it
raises where CUDA is missing; `--device cpu` runs on the CPU): the
runners' commands, sdps-preprocess, and evaluation, whose LPIPS
(`--lpips_weights`, else LPIPS_WEIGHTS) runs there; evaluation without
weights touches no device.

stage1-train and stage2-train take `--mesh-devices N`: data-parallel
training on N ranks, one process a device (psnerf_torch.parallel.launch
spawns them: rank r on cuda:r, or N CPU ranks under `--device cpu`; under
torchrun each process is one rank already and builds its mesh from the
environment). Rank 0 writes the checkpoints and metrics.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="psnerf_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def runner_parser(name, **kw):
        p = sub.add_parser(name, **kw)
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs on the "
                            "CPU)")
        return p

    p = runner_parser("stage1-train")
    p.add_argument("config")
    p.add_argument("--workdir", default=None)
    p.add_argument("--max-iters", type=int, default=100000)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="data-parallel training over N devices, one rank "
                        "each (1-D 'rays' mesh; params replicated, batches "
                        "sharded, one gradient all-reduce a step)")

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
                   help="data-parallel training over N devices, one rank "
                        "each")

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

    p = runner_parser("evaluation")
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
                       help="reference torch checkpoint -> npz")
    p.add_argument("--stage", choices=["stage1", "stage2", "lcnet", "nenet"],
                   required=True)
    p.add_argument("--model", required=True, help="torch .pt/.pth[.tar] path")
    p.add_argument("--lights", default=None,
                   help="stage2 LightParameters .pth (optional)")
    p.add_argument("--out", required=True, help="output .npz path")

    p = runner_parser("sdps-preprocess",
                      help="run SDPS-Net (LCNet+NENet) over a dataset")
    p.add_argument("--obj", required=True, help="dataset directory")
    p.add_argument("--lcnet", required=True, help="converted or torch ckpt")
    p.add_argument("--nenet", required=True)
    p.add_argument("--train_light", type=int, default=None)
    p.add_argument("--intnorm_gt", action="store_true")
    return parser


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    n_ranks = getattr(args, "mesh_devices", None)
    if not n_ranks:
        return run(args)
    from psnerf_torch.parallel import launch, make_mesh

    if "WORLD_SIZE" in os.environ:            # a rank under torchrun
        return run(args, make_mesh(n_ranks, device=args.device))
    launch(run_rank, n_ranks, args, device=args.device)


def run_rank(mesh, args):
    """One rank of a `--mesh-devices` run (launch's target)."""
    run(args, mesh)


def run(args, mesh=None):
    """Run the parsed command, on the ranks of `mesh` if one is given."""
    cmd = args.cmd
    if cmd in ("stage1-train", "stage1-eval", "shape-extract", "extract-mesh"):
        from psnerf_torch.config import stage1_config_from_yaml
        from psnerf_torch.runners.stage1 import Stage1Runner

        cfg = stage1_config_from_yaml(args.config)
        workdir = args.workdir or cfg.out_dir
        runner = Stage1Runner(cfg, workdir,
                              resume=not getattr(args, "no_resume", False),
                              device=args.device, mesh=mesh)
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
        runner = Stage2Runner(cfg, workdir, device=args.device, mesh=mesh)
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

        res = evaluate_outputs(args.data_path, args.test_out_path,
                               args.inten_normalize,
                               lpips_weights=args.lpips_weights,
                               device=args.device)
        print(json.dumps(res, indent=2))

    elif cmd == "chamfer":
        from psnerf_torch.mesh.chamfer import chamfer_distance
        from psnerf_torch.mesh.meshio import load_mesh

        vg, tg = load_mesh(args.mesh_gt)
        vp, tp = load_mesh(args.mesh_pred)
        cd = chamfer_distance(vp, tp, vg, tg, args.num_samples)
        print(f"Chamfer Distance (mm):  {cd * 1000:.2f}")

    elif cmd == "light-avg":
        from psnerf_torch.preprocess.light_avg import light_average

        light_average(args.obj, intnorm=args.intnorm)

    elif cmd == "convert-ckpt":
        from psnerf_torch import convert
        from psnerf_torch.preprocess import sdps
        from psnerf_torch.train.checkpoints import save_checkpoint

        blob = convert.load_torch_file(args.model)
        if args.stage == "stage1":
            tree = convert.stage1_params_from_torch(blob)
        elif args.stage == "stage2":
            lights = (convert.load_torch_file(args.lights) if args.lights
                      else None)
            tree = convert.stage2_params_from_torch(blob, lights)
        elif args.stage == "lcnet":
            tree = sdps.load_lcnet_torch(blob.get("state_dict", blob))
        else:
            tree = sdps.load_nenet_torch(blob.get("state_dict", blob))
        save_checkpoint(args.out, tree)
        print(f"converted {args.stage} checkpoint -> {args.out}")

    elif cmd == "sdps-preprocess":
        from psnerf_torch.preprocess.runner import run_sdps
        from psnerf_torch.preprocess.sdps import load_sdps_net

        out = run_sdps(args.obj,
                       load_sdps_net(args.lcnet, "lcnet", args.device),
                       load_sdps_net(args.nenet, "nenet", args.device),
                       train_light=args.train_light,
                       light_intnorm_gt=args.intnorm_gt)
        print(f"SDPS outputs written to {out}")


if __name__ == "__main__":
    main()
