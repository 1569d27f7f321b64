"""Run configs and their loaders (counterpart of psnerf_tpu/config.py, same
field names and the same results from the same files).

  * stage-1 YAML with a recursive `inherit_from` merge
    (`load_yaml_config`, `stage1_config_from_yaml`). The YAML is parsed
    here, without PyYAML: `parse_yaml` reads the subset that config files
    use (block mappings, flow lists, comments, quoted and plain scalars)
    and resolves plain scalars as `yaml.safe_load` does (YAML 1.1), quirks
    included: `5e-4` and `1.0e3` stay strings (a float needs a dot and a
    signed exponent), `1.0e-3` is a float, `yes`/`on` are True, `~` and an
    empty value are None. Syntax outside the subset raises ValueError
    naming the line; nothing is guessed.
  * stage-2 HOCON `.conf` files through a minimal reader (`parse_hocon`,
    `load_hocon`, `hocon_get`, `stage2_config_from_conf`): nested blocks,
    `key = value` / `key : value`, lists, comments.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

from psnerf_torch.fields.occupancy import OccFieldConfig
from psnerf_torch.fields.psnet import PSNetConfig
from psnerf_torch.render.unisurf import UnisurfConfig
from psnerf_torch.train.losses import Stage1LossWeights, Stage2LossWeights
from psnerf_torch.train.stage1 import Stage1TrainConfig
from psnerf_torch.train.stage2 import Stage2TrainConfig


# ------------------------------------------------------------- YAML subset

# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py), tried in its
# order for a plain scalar's first character
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_RESOLVERS = (("bool", _BOOL, "yYnNtTfFoO"), ("float", _FLOAT,
              "-+0123456789."), ("int", _INT, "-+0123456789"),
              ("null", _NULL, "~nN"), ("timestamp", _TIMESTAMP, "0123456789"))
# characters a plain scalar may not start with (a `-`, `?` or `:` only when
# a space or the end follows)
_INDICATORS = ",[]{}#&*!|>'\"%@`"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(parts, cast):
    value = cast(0)
    for part in parts:
        value = value * 60 + cast(part)
    return value


def _yaml_int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    v = v[1:] if v[0] in "+-" else v
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v.split(":"), int)
    return sign * int(v)


def _yaml_float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1 if v[0] == "-" else 1
    v = v[1:] if v[0] in "+-" else v
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v.split(":"), float)
    return sign * float(v)


def resolve_plain_scalar(text: str, lineno: int = 0) -> Any:
    """A plain (unquoted) scalar as yaml.safe_load resolves it: bool,
    float, int, None, else the string itself. Timestamps, merge keys and
    the value key are outside the subset and raise."""
    for kind, pattern, first in _RESOLVERS:
        if text[:1] in first and pattern.match(text):   # '' is in any
            if kind == "bool":
                return text.lower() in ("yes", "true", "on")
            if kind == "float":
                return _yaml_float(text)
            if kind == "int":
                return _yaml_int(text)
            if kind == "null":
                return None
            raise ValueError(f"YAML line {lineno}: timestamp {text!r} is "
                             "outside the supported subset")
    if text in ("<<", "="):
        raise ValueError(f"YAML line {lineno}: {text!r} is outside the "
                         "supported subset")
    return text


class _Line:
    """A cursor over one line of YAML; `err` raises naming the line."""

    def __init__(self, text: str, lineno: int, pos: int):
        self.s, self.no, self.pos = text, lineno, pos

    def err(self, msg: str):
        raise ValueError(f"YAML line {self.no}: {msg}: {self.s.strip()!r}")

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.s[i] if i < len(self.s) else ""

    def skip_spaces(self):
        while self.peek() in (" ", "\t"):
            self.pos += 1

    def at_comment_or_end(self) -> bool:
        """After spaces: the end of the line, or a `#` comment (which must
        follow whitespace)."""
        self.skip_spaces()
        if not self.peek():
            return True
        return self.peek() == "#" and self.s[self.pos - 1] in " \t"

    def expect_end(self):
        if not self.at_comment_or_end():
            self.err("unexpected text after a value")

    def quoted(self) -> str:
        q = self.peek()
        self.pos += 1
        out = []
        while True:
            c = self.peek()
            if not c:
                self.err("unterminated quoted string (a quoted string must "
                         "end on its line)")
            self.pos += 1
            if q == "'":
                if c == "'":
                    if self.peek() == "'":
                        out.append("'")
                        self.pos += 1
                        continue
                    return "".join(out)
                out.append(c)
            elif c == '"':
                return "".join(out)
            elif c == "\\":
                e = self.peek()
                self.pos += 1
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in _HEX_ESCAPES:
                    digits = self.s[self.pos:self.pos + _HEX_ESCAPES[e]]
                    if not re.fullmatch(r"[0-9a-fA-F]+", digits) or len(
                            digits) != _HEX_ESCAPES[e]:
                        self.err(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += len(digits)
                else:
                    self.err(f"unknown escape \\{e}")
            else:
                out.append(c)

    def check_plain_start(self):
        c, nxt = self.peek(), self.peek(1)
        if c in _INDICATORS or (c in "-?:" and nxt in ("", " ", "\t")):
            self.err(f"a scalar starting with {c!r} is outside the supported "
                     "subset (sequences, anchors, tags, block scalars, flow "
                     "mappings)")

    def plain(self, flow: bool) -> Any:
        """A plain scalar up to the end, a comment, or (in a flow list) a
        `,` or `]`; resolved."""
        self.check_plain_start()
        start = self.pos
        while True:
            c = self.peek()
            if not c or (flow and c in ",]"):
                break
            if c == "#" and self.s[self.pos - 1] in " \t":
                if flow:
                    self.err("a comment inside a flow list")
                break
            if flow and c in "[{}":
                self.err(f"{c!r} inside a flow list's plain scalar")
            if c == ":" and self.peek(1) in ("", " ", "\t") + (
                    (",", "]") if flow else ()):
                self.err("a mapping inside a value is outside the subset")
            self.pos += 1
        return resolve_plain_scalar(self.s[start:self.pos].rstrip(" \t"),
                                    self.no)

    def flow_list(self) -> list:
        self.pos += 1                                    # '['
        items = []
        self.skip_spaces()
        if self.peek() == "]":
            self.pos += 1
            return items
        while True:
            self.skip_spaces()
            c = self.peek()
            if not c:
                self.err("a flow list must end on its line")
            if c == "]" and items:                       # after a trailing ,
                self.pos += 1
                return items
            if c == ",":
                self.err("an empty flow list entry")
            if c == "[":
                items.append(self.flow_list())
            elif c in "'\"":
                items.append(self.quoted())
            else:
                items.append(self.plain(flow=True))
            self.skip_spaces()
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c == "]":
                self.pos += 1
                return items
            else:
                self.err("expected ',' or ']' in a flow list")

    def value(self) -> tuple[bool, Any]:
        """(has a value, the value) after `key:`; no value means a nested
        block or None."""
        if self.at_comment_or_end():
            return False, None
        c = self.peek()
        if c in "'\"":
            v = self.quoted()
        elif c == "[":
            v = self.flow_list()
        else:
            return True, self.plain(flow=False)
        self.expect_end()
        return True, v

    def key(self) -> Any:
        c = self.peek()
        if c in "'\"":
            k = self.quoted()
            self.skip_spaces()
            if self.peek() != ":" or self.peek(1) not in ("", " ", "\t"):
                self.err("expected ':' after a quoted key")
            self.pos += 1
            return k
        self.check_plain_start()
        start = self.pos
        while True:
            c = self.peek()
            if not c:
                self.err("expected 'key: value' (scalar documents and "
                         "multi-line scalars are outside the subset)")
            if c == "#" and self.s[self.pos - 1] in " \t":
                self.err("a comment before the key's ':'")
            if c == ":" and self.peek(1) in ("", " ", "\t"):
                break
            self.pos += 1
        k = self.s[start:self.pos].rstrip(" \t")
        self.pos += 1
        return resolve_plain_scalar(k, self.no)


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset of config files into what yaml.safe_load
    returns: nested dicts of block mappings (any consistent indentation),
    one-line flow lists (nested allowed), `#` comments, single- and
    double-quoted strings, and plain scalars resolved as YAML 1.1 resolves
    them (resolve_plain_scalar). A later duplicate key replaces the earlier
    one. An empty document gives None. Block sequences, anchors, tags,
    block scalars, flow mappings, multi-line scalars, documents markers and
    tabs in indentation raise ValueError naming the line."""
    root: dict = {}
    stack: list = [[None, root]]        # [indent of its keys, mapping]
    pending = None                      # (mapping, key, indent): `key:` alone
    seen = False
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t") or (not body.strip(" \t")):
            if body.strip(" \t"):
                _Line(raw, no, 0).err("a tab in indentation")
            continue
        if body.startswith("#"):
            continue
        indent = len(raw) - len(body)
        if indent == 0 and (body.startswith("---") or body.startswith("...")):
            _Line(raw, no, 0).err("document markers are outside the subset")
        line = _Line(raw, no, indent)
        if pending is not None:
            mapping, key, key_indent = pending
            pending = None
            if indent > key_indent:
                child: dict = {}
                mapping[key] = child
                stack.append([indent, child])
            else:
                mapping[key] = None
        while stack[-1][0] is not None and stack[-1][0] > indent:
            stack.pop()
        if stack[-1][0] is None:
            stack[-1][0] = indent
        elif stack[-1][0] != indent:
            line.err("indentation matches no enclosing mapping")
        seen = True
        mapping = stack[-1][1]
        key = line.key()
        has_value, value = line.value()
        if has_value:
            mapping[key] = value
        else:
            mapping[key] = None
            pending = (mapping, key, indent)
    return root if seen else None


# --------------------------------------------------------------- YAML files

def load_yaml_config(path: str) -> dict:
    """YAML with a recursive inherit_from merge (configloading.py:3-47); the
    inherited path is opened as given (relative to the working directory)."""
    with open(path) as f:
        cfg_special = parse_yaml(f.read())
    inherit_from = cfg_special.get("inherit_from")
    cfg = load_yaml_config(inherit_from) if inherit_from is not None else {}
    _update_recursive(cfg, cfg_special)
    return cfg


def _update_recursive(dict1: dict, dict2: dict) -> None:
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {}
        if isinstance(v, dict):
            _update_recursive(dict1[k], v)
        else:
            dict1[k] = v


# --------------------------------------------------------------- mini-HOCON

def load_hocon(path: str) -> dict:
    with open(path) as f:
        return parse_hocon(f.read())


def _strip_hocon_comments(text: str) -> str:
    """Remove `#` / `//` comments outside double quotes, line by line."""
    out_lines = []
    for line in text.splitlines():
        in_q = False
        cut = len(line)
        i = 0
        while i < len(line):
            c = line[i]
            if c == '"':
                in_q = not in_q
            elif not in_q and (c == "#" or line[i:i + 2] == "//"):
                cut = i
                break
            i += 1
        out_lines.append(line[:cut])
    return "\n".join(out_lines)


def parse_hocon(text: str) -> dict:
    """Parse the HOCON subset of the reference confs: nested `name { ... }`
    blocks, multi-line or single-line, `key = value` / `key : value`, `,`
    or newline separators, `#`/`//` comments, bools, ints, floats, lists
    and strings (unquoted allowed). Duplicate blocks merge. Unsupported
    syntax raises ValueError."""
    src = _strip_hocon_comments(text)
    pos = 0
    n = len(src)

    def err(msg):
        line = src.count("\n", 0, pos) + 1
        raise ValueError(f"HOCON parse error at line {line}: {msg}")

    def skip_ws(include_sep=True):
        nonlocal pos
        seps = " \t\r\n," if include_sep else " \t"
        while pos < n and src[pos] in seps:
            pos += 1

    def read_key():
        nonlocal pos
        start = pos
        while pos < n and src[pos] not in "=:{}\n":
            pos += 1
        key = src[start:pos].strip()
        if not key:
            err("expected a key")
        if pos >= n or src[pos] == "\n" or src[pos] == "}":
            err(f"key {key!r} has no value or block")
        return key

    def read_balanced(open_c, close_c):
        nonlocal pos
        start = pos
        depth = 0
        while pos < n:
            c = src[pos]
            if c == '"':
                pos += 1
                while pos < n and src[pos] != '"':
                    pos += 1
            elif c == open_c:
                depth += 1
            elif c == close_c:
                depth -= 1
                if depth == 0:
                    pos += 1
                    return src[start:pos]
            pos += 1
        err(f"unbalanced {open_c}{close_c}")

    def read_value():
        nonlocal pos
        skip_ws(include_sep=False)
        if pos >= n:
            err("expected a value")
        c = src[pos]
        if c == "{":
            pos += 1
            return read_object(stop_at_brace=True)
        if c == "[":
            return _hocon_value(" ".join(read_balanced("[", "]").split()))
        if c == '"':
            start = pos
            pos += 1
            while pos < n and src[pos] != '"':
                pos += 1
            if pos >= n:
                err("unterminated string")
            pos += 1
            return src[start + 1:pos - 1]
        start = pos
        while pos < n and src[pos] not in "\n,}":
            pos += 1
        v = src[start:pos].strip()
        if not v:
            err("empty value")
        return _hocon_value(v)

    def read_object(stop_at_brace: bool) -> dict:
        nonlocal pos
        obj: dict = {}
        while True:
            skip_ws()
            if pos >= n:
                if stop_at_brace:
                    err("unbalanced braces")
                return obj
            if src[pos] == "}":
                if not stop_at_brace:
                    err("unbalanced braces")
                pos += 1
                return obj
            key = read_key()
            if src[pos] == "{":
                pos += 1
                child = read_object(stop_at_brace=True)
            else:
                pos += 1  # '=' or ':'
                child = read_value()
            if isinstance(child, dict) and isinstance(obj.get(key), dict):
                _update_recursive(obj[key], child)
            else:
                obj[key] = child

    return read_object(stop_at_brace=False)


def _hocon_value(v: str) -> Any:
    if v.startswith("[") and v.endswith("]"):
        inner = v[1:-1].strip()
        return [] if not inner else [_hocon_value(x.strip())
                                     for x in inner.split(",")]
    if v.startswith('"') and v.endswith('"'):
        return v[1:-1]
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if re.fullmatch(r"[+-]?\d+", v):
        return int(v)
    try:
        return float(v)
    except ValueError:
        return v


def hocon_get(conf: dict, dotted: str, default=None):
    cur = conf
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


# ----------------------------------------------------------- typed configs

@dataclasses.dataclass(frozen=True)
class Stage1Config:
    field: OccFieldConfig
    render: UnisurfConfig
    train: Stage1TrainConfig
    data_dir: str = ""
    obj_name: str = ""
    out_dir: str = "out"
    inten_normalize: str | None = "sdps"
    train_view: int | None = None
    train_light: int | None = None
    all_view: bool = False
    mask_black: bool = False
    est_norm: bool = True
    visualize_every: int = 10000
    print_every: int = 200
    backup_every: int = 10000
    checkpoint_every: int = 5000
    max_iters: int = 100000
    extraction_resolution: int = 64
    extraction_upsampling: int = 3
    extraction_refinement: int = 0


def stage1_config_from_yaml(path: str) -> Stage1Config:
    cfg = load_yaml_config(path)
    m, r, t, d = (cfg["model"], cfg["rendering"], cfg["training"],
                  cfg["dataloading"])
    e = cfg.get("extraction", {})
    field = OccFieldConfig(
        num_layers=m["num_layers"], hidden_dim=m["hidden_dim"],
        octaves_pe=m["octaves_pe"], octaves_pe_views=m["octaves_pe_views"],
        skips=tuple(m["skips"]), feat_size=m["feat_size"],
        rescale=m["rescale"], geometric_init=m["geometric_init"],
        compute_dtype=m.get("compute_dtype", "float32"),
    )
    render = UnisurfConfig(
        near=r["near"], far=r["far"], radius=r["radius"],
        interval_start=r["interval_start"], interval_end=r["interval_end"],
        interval_decay=r["interval_decay"], num_points_in=r["num_points_in"],
        num_points_out=r["num_points_out"],
        ray_marching_steps=r["ray_marching_steps"],
        white_background=r["white_background"],
    )
    weights = Stage1LossWeights(
        lambda_rgb=t.get("lambda_l1_rgb", 1.0),
        lambda_smooth=t.get("lambda_normals", 0.005),
        lambda_normal=t.get("lambda_normloss", 1.0),
        lambda_mask=t.get("lambda_mask", 1.0),
        use_mask_loss=t.get("mask_loss", False),
    )
    # the reference's milestones are epochs (its scheduler steps per epoch,
    # stage1/train.py:135); the runner converts them with the views per
    # epoch (milestones_epochs_to_iters)
    train = Stage1TrainConfig(
        learning_rate=t.get("learning_rate", 1e-4),
        weight_decay=t.get("weight_decay", 0.0),
        milestone_iters=tuple(t.get("scheduler_milestones", [])),
        gamma=t.get("scheduler_gamma", 0.5),
        n_training_points=t.get("n_training_points", 2048),
        normal_after=t.get("normal_after", 1000),
        weights=weights,
    )
    return Stage1Config(
        field=field, render=render, train=train,
        data_dir=d["data_dir"], obj_name=d.get("obj_name", ""),
        out_dir=t.get("out_dir", "out"),
        inten_normalize=d.get("inten_normalize"),
        train_view=d.get("train_view"), train_light=d.get("train_light"),
        all_view=d.get("all_view", False),
        mask_black=t.get("mask_black", False),
        est_norm=t.get("est_norm", True),
        visualize_every=t.get("visualize_every", 10000),
        print_every=t.get("print_every", 200),
        backup_every=t.get("backup_every", 10000),
        checkpoint_every=t.get("checkpoint_every", 5000),
        extraction_resolution=e.get("resolution", 64),
        extraction_upsampling=e.get("upsampling_steps", 3),
        extraction_refinement=e.get("refinement_step", 0),
    )


def milestones_epochs_to_iters(milestones, views_per_epoch: int):
    return tuple(int(m) * int(views_per_epoch) for m in milestones)


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    net: PSNetConfig
    train: Stage2TrainConfig
    data_dir: str = ""
    obj_name: str = ""
    expname: str = "default"
    stage1_shape_path: str = ""
    inten_normalize: str | None = "sdps"
    train_view: int | None = None
    train_light: int | None = None
    all_view: bool = False
    multi_light: bool = True
    light_bs: int = 10
    light_init: str = "pred"
    light_inten_init: str = "same"
    num_pixels: int = 8192
    train_all_pixels: bool = True
    sample_in_mask: bool = True
    vis_loss: bool = True
    vis_plus: bool = True
    vis_train_num: int = 8
    image_store: str = "auto"
    normal_train: bool = True
    plot_freq: int = 1000
    ckpt_freq: int = 1000
    nepochs: int = 20000
    sched_milestones_epochs: tuple = ()


def stage2_config_from_conf(path: str) -> Stage2Config:
    c = load_hocon(path)
    g = lambda k, d=None: hocon_get(c, k, d)
    net = PSNetConfig(
        render_model=g("train.render_model", "sgbasis"),
        nbasis=g("train.nbasis", 9),
        specular_rgb=g("train.specular_rgb", False),
        fresnel_f0=g("brdf.fresnel_f0", 0.05),
        light_int=g("brdf.light_intensity", 4.0),
        n_freqs_xyz=g("brdf.net.n_freqs_xyz", 10),
        mlp_width=g("brdf.net.mlp_width", 128),
        mlp_depth=g("brdf.net.mlp_depth", 4),
        mlp_skip_at=g("brdf.net.mlp_skip_at", 2),
        xyz_jitter_std=g("brdf.net.xyz_jitter_std", 0.0),
        sg_mlp_width=g("brdf.sgnet.mlp_width", 64),
        sg_mlp_depth=g("brdf.sgnet.mlp_depth", 2),
        sg_mlp_skip_at=g("brdf.sgnet.mlp_skip_at", -1),
        normal_mlp=g("train.normal_mlp", False),
        normal_joint=g("train.normal_joint", False),
        normal_n_freqs_xyz=g("normal.net.n_freqs_xyz", 10),
        normal_mlp_width=g("normal.net.mlp_width", 128),
        normal_mlp_depth=g("normal.net.mlp_depth", 4),
        normal_mlp_skip_at=g("normal.net.mlp_skip_at", 2),
        normal_jitter_std=g("normal.net.xyz_jitter_std", 0.0),
        visibility=g("train.visibility", False),
        light_vis_detach=g("train.light_vis_detach", False),
        vis_rgb_detach=g("train.vis_rgb_detach", False),
        vis_mlp_width=g("visibility.net.mlp_width", 256),
        vis_mlp_depth=g("visibility.net.mlp_depth", 8),
        vis_mlp_skip_at=g("visibility.net.mlp_skip_at", 4),
    )
    weights = Stage2LossWeights(
        sg_rgb_weight=g("loss.sg_rgb_weight", 1.0),
        loss_type=g("loss.loss_type", "L1"),
        albedo_smooth_weight=g("loss.albedo_smooth_weight", 0.0),
        rough_smooth_weight=g("loss.rough_smooth_weight", 0.0),
        vis_weight=g("loss.vis_weight", 1.0),
        normal_weight=g("normal.loss.normal_weight", 1.0),
        normal_smooth_weight=g("normal.loss.normal_smooth_weight", 0.0),
    )
    train = Stage2TrainConfig(
        sg_learning_rate=g("train.sg_learning_rate", 5e-4),
        light_learning_rate=g("train.light_learning_rate", 5e-4),
        light_inten_lr=g("train.light_inten_lr",
                         g("train.light_learning_rate", 5e-4)),
        gamma=g("train.sg_sched_factor", 0.5),
        light_train=g("train.light_train", False),
        light_inten_train=g("train.light_inten_train", False),
        light_decay=g("train.light_decay", False),
        train_order=g("train.train_order", False),
        ana_fixlight=g("train.ana_fixlight", False),
        weights=weights,
    )
    return Stage2Config(
        net=net, train=train,
        data_dir=g("dataset.data_dir", ""),
        obj_name=g("dataset.obj_name", ""),
        expname=g("train.expname", "default"),
        stage1_shape_path=g("train.stage1_shape_path", ""),
        inten_normalize=g("dataset.inten_normalize"),
        train_view=g("dataset.train_view"),
        train_light=g("dataset.train_light"),
        all_view=g("dataset.all_view", False),
        multi_light=g("train.multi_light", False),
        light_bs=g("train.light_bs", 32),
        light_init=g("train.light_init", "pred"),
        light_inten_init=g("train.light_inten_init", "same"),
        num_pixels=g("train.num_pixels", 8192),
        train_all_pixels=g("train.train_all_pixels", False),
        sample_in_mask=g("train.sample_in_mask", False),
        vis_loss=g("train.vis_loss", False),
        vis_plus=g("train.vis_plus", False),
        vis_train_num=g("train.vis_train_num", 16),
        normal_train=(g("train.normal_mlp", False)
                      and g("train.normal_joint", False)),
        plot_freq=g("train.plot_freq", 1000),
        ckpt_freq=g("train.ckpt_freq", 1000),
        sched_milestones_epochs=tuple(g("train.sg_sched_milestones", [])
                                      or []),
    )
