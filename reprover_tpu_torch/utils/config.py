"""Dataclass config system: YAML files + dotted CLI overrides + field links.

A copy of :mod:`reprover_tpu.utils.config` (importing that module runs
``reprover_tpu/utils/__init__.py``, which imports JAX and Orbax), with one
repair: overrides of nested configs layer onto the parent's defaults at
every depth, not only the first (see :func:`_build`).

    cfg = parse_config(TrainConfig, argv)
    # argv: [fit] [--config conf.yaml] [--model.lr 1e-4] [--data.batch_size 8]

Nested dataclasses map to dotted flags; YAML keys merge under CLI overrides;
``links`` copy one resolved field into another (the reference's
link_arguments role, e.g. data.max_seq_len -> model.max_seq_len).
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _is_dataclass_type(t: Any) -> bool:
    return isinstance(t, type) and dataclasses.is_dataclass(t)


def _coerce(value: str, annotation: Any) -> Any:
    """Parse a CLI string into the annotated type."""
    origin = typing.get_origin(annotation)
    if origin is typing.Union or isinstance(annotation, types.UnionType):
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if value.lower() in ("null", "none"):
            return None
        return _coerce(value, args[0])
    if annotation is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if annotation is int:
        return int(value)
    if annotation is float:
        return float(value)
    if origin in (list, typing.List):
        item = typing.get_args(annotation)[0] if typing.get_args(annotation) else str
        return [_coerce(v.strip(), item) for v in value.split(",") if v.strip()]
    return value


def _merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_dotted(tree: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _get_dotted(obj: Any, dotted: str) -> Any:
    for k in dotted.split("."):
        obj = getattr(obj, k)
    return obj


def _set_dotted_attr(obj: Any, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    for k in keys[:-1]:
        obj = getattr(obj, k)
    setattr(obj, keys[-1], value)


def _field_default(f: dataclasses.Field) -> Any:
    """The field's default INSTANCE (factory-built or literal), or None."""
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f.default_factory()  # type: ignore[misc]
    if f.default is not dataclasses.MISSING and dataclasses.is_dataclass(
        f.default
    ):
        return f.default
    return None


def _build(cls: Any, data: Dict[str, Any], prefix: str = "", base: Any = None) -> Any:
    """Instantiate a (nested) dataclass from a dict, type-checking keys.

    Overrides are layered ON TOP of the default instance at every depth: a
    nested dict is built on the parent's default for that field (the
    parent's ``default_factory`` instance, or the field of ``base`` when the
    parent itself was layered on one), so a parent that customizes a
    sub-config keeps those customizations when the CLI overrides only some
    fields, however deep the override. (Regression, depth 1:
    ``--trainer.max_steps`` on the pretrain CLI reset its
    ``monitor="loss_val"`` default to the class's Recall@10_val. The JAX
    package's copy layers one level only, so a depth-2 override still reset
    a customized grandchild; this copy recurses.)"""
    hints = typing.get_type_hints(cls)
    kwargs: Dict[str, Any] = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            raise ValueError(f"unknown config key: {prefix}{key}")
        ann = hints[key]
        if _is_dataclass_type(ann) and isinstance(value, dict):
            sub_base = getattr(base, key) if base is not None else _field_default(fields[key])
            kwargs[key] = _build(ann, value, prefix=f"{prefix}{key}.", base=sub_base)
        elif isinstance(value, str):
            kwargs[key] = _coerce(value, ann)
        else:
            kwargs[key] = value
    if base is None:
        return cls(**kwargs)
    return dataclasses.replace(base, **kwargs)


def parse_config(
    cls: Any,
    argv: Sequence[str],
    links: Optional[List[Tuple[str, str]]] = None,
) -> Tuple[Optional[str], Any]:
    """Parse ``argv`` into (subcommand, config instance).

    - a bare leading token (fit/validate/predict/...) is the subcommand;
    - ``--config path.yaml`` loads YAML (repeatable; later wins);
    - ``--a.b.c value`` sets a nested field;
    - ``links`` = [(src_dotted, dst_dotted)] copied after resolution.
    """
    import yaml

    argv = list(argv)
    subcommand = None
    if argv and not argv[0].startswith("-"):
        subcommand = argv.pop(0)

    tree: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"expected a --flag, got {arg!r}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
            i += 1
        else:
            key = arg[2:]
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for --{key}")
            value = argv[i + 1]
            i += 2
        if key == "config":
            with open(value) as f:
                tree = _merge(tree, yaml.safe_load(f) or {})
        else:
            _set_dotted(tree, key, value)

    cfg = _build(cls, tree)
    for src, dst in links or []:
        _set_dotted_attr(cfg, dst, _get_dotted(cfg, src))
    return subcommand, cfg


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
