"""The port's surface against the JAX package's, on the CPU.

For every module of `sharp_tpu` and every public function and class it
defines (a function under `jax.jit` is read through its `__wrapped__`
function), the module of the same name in `sharp_tpu_torch` has a counterpart
of the same name that takes every JAX parameter by name; the JAX
positional parameters are, in order, a prefix of the port's positional
parameters, with equal defaults wherever the JAX package has one (dtypes
compared by name). The port may add parameters after them, or keyword-only
ones. Beside the functions: the UPPER_CASE constants each module assigns
(equal values), the names each subpackage's `__init__` exports (`__all__`:
the same kind of object, the one of the module the JAX object comes from),
`SharpConfig`'s fields and defaults, the CLI subcommands' arguments, and
the `SHARP_TPU_*` environment variables each package reads.

`EXCLUSIONS` lists what differs on purpose, one reason per row; a row that
no longer names a difference fails `test_every_exclusion_names_a_difference`.
"""

import argparse
import ast
import dataclasses
import importlib
import inspect
import os
import pkgutil
import re

import numpy as np
import pytest
import torch

import sharp_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = ("threefry key: torch cannot reproduce JAX's threefry streams, so the port takes a seed or a "
       "torch.Generator, and the JAX package's draws through sharp_tpu_torch.carry")
PRNG = "a threefry key helper of utils/prng: " + KEY

# what: "module", "module.name", "module.name(param)", "cli --flag" or
# "env NAME" ("package.name" for a subpackage's export); stand-in: the port's parameters in place of a JAX parameter
EXCLUSIONS = {
    "ops.linkage_pallas": (None, "the Pallas kernels; the port's are ops/linkage_cuda over csrc/*.cu"),
    "utils.cache": (None, "turns on JAX's compilation cache; the port compiles nothing but its kernels "
                          "(ops/_build, keyed on the source)"),
    "utils.prng.seed_to_key": (None, PRNG),
    "utils.prng.member_key": (None, PRNG),
    "utils.prng.shuffle_key": (None, PRNG),
    "utils.prng.testlog_key": (None, PRNG),
    "utils.seed_to_key": (None, PRNG),
    "utils.member_key": (None, PRNG),
    "core.pipeline.testlog_decide(key)": (("rN_seed",), KEY),
    "core.pipeline.resolve_log_transform(key)": (("rN_seed",), KEY),
    "core.pipeline.sharp_small(key)": (("rN_seed", "device"), KEY),
    "core.large.sharp_large(key)": (("rN_seed", "device"), KEY),
    "ops.rp.ternary_rp_matrix(key)": (("gen",), KEY),
    "ops.rp.ensemble_rp_matrix(key)": (("rN_seed",), KEY),
    "parallel.sharded.ens_sharded_fold_fn": (None, "builds a jit-sharded fold program over a JAX mesh; the "
                                                   "port's ensemble split is parallel/sharded._ens_program"),
    "parallel.sharded.process_folds_sharded": (None, "takes the folds sliced and padded (X_folds, n_reals); the "
                                                     "port's slices them in the pass, from X, sizes and rows"),
    "cli --device": (None, "the port's device (cuda or cpu); the JAX CLI picks its platform from "
                           "SHARP_TPU_PLATFORM"),
    "cli --dtype-compute": (None, "the port's compute dtype knob, which the JAX CLI leaves at its default"),
    "env SHARP_TPU_PLATFORM": (None, "the JAX CLI's platform switch; the port's CLI takes --device"),
}

JAX_MODULES = sorted(
    m.name[len("sharp_tpu."):]
    for m in pkgutil.walk_packages(sharp_tpu.__path__, "sharp_tpu.")
    if not m.name.endswith("__main__")
)


def _unjit(obj):
    """The Python function under a `jax.jit` wrapper (a callable whose
    `__wrapped__` is a function), else obj itself."""
    inner = getattr(obj, "__wrapped__", None)
    if callable(obj) and not inspect.isfunction(obj) and inspect.isfunction(inner):
        return inner
    return obj


def _kind(obj):
    obj = _unjit(obj)
    if inspect.ismodule(obj):
        return "module"
    return "function" if inspect.isfunction(obj) else "class" if inspect.isclass(obj) else None


def _public(mod):
    """The public functions (jit-wrapped ones through `_unjit`) and classes
    a module defines itself."""
    out = {}
    for name, obj in vars(mod).items():
        obj = _unjit(obj)
        if (not name.startswith("_") and _kind(obj)
                and getattr(obj, "__module__", None) == mod.__name__):
            out[name] = obj
    return out


def _positional(sig):
    return [p for p in sig.parameters.values() if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _same_default(a, b):
    """Equal defaults; dtypes of either package compared by name."""
    def name(x):
        if isinstance(x, torch.dtype):
            return str(x).split(".")[-1]
        try:
            return np.dtype(x).name if isinstance(x, type) or hasattr(x, "dtype") else x
        except TypeError:
            return x

    return name(a) == name(b)


def _function_gaps(what, theirs_fn, ours_fn):
    """{key: what is wrong} of the port's `ours_fn` against the JAX
    package's `theirs_fn`, parameter rows of `EXCLUSIONS` applied."""
    if ours_fn is None:
        return {what: "missing"}
    try:
        js, ts = inspect.signature(theirs_fn), inspect.signature(ours_fn)
    except (TypeError, ValueError):
        return {}
    out = {}
    expected = []   # the JAX positional parameters, stand-ins in place
    for p in js.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        key = f"{what}({p.name})"
        stand_in = EXCLUSIONS.get(key, (None,))[0]
        if stand_in is not None:
            out[key] = "excluded"
            expected += [(n, inspect.Parameter.empty) for n in stand_in]
        elif p.name not in ts.parameters:
            out[key] = "missing"
        elif p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            expected.append((p.name, p.default))
    got = _positional(ts)
    for i, (pname, default) in enumerate(expected):
        if i >= len(got) or got[i].name != pname:
            out[f"{what}({pname})"] = f"positional {i} is {got[i].name if i < len(got) else 'absent'} in the port"
        elif default is not inspect.Parameter.empty and not _same_default(default, got[i].default):
            out[f"{what}({pname})"] = f"default {default!r} in the JAX package, {got[i].default!r} in the port"
    return out


def _differences(jax_mod: str):
    """What the port's module lacks of the JAX module `jax_mod`, as keys in
    the form of `EXCLUSIONS`, each with what is wrong ("excluded" where a
    row of the table excuses a difference that exists)."""
    jm = importlib.import_module("sharp_tpu." + jax_mod)
    try:
        tm = importlib.import_module("sharp_tpu_torch." + jax_mod)
    except ImportError as e:
        return {jax_mod: "excluded" if jax_mod in EXCLUSIONS else f"no module: {e}"}
    out = {}
    for name, obj in _public(jm).items():
        what = f"{jax_mod}.{name}"
        gaps = _function_gaps(what, obj, getattr(tm, name, None))
        if what in EXCLUSIONS:
            gaps = {what: "excluded"} if any(v != "excluded" for v in gaps.values()) else {}
        out.update(gaps)
    return out


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_surface_matches_the_jax_package(module):
    gaps = {k: v for k, v in _differences(module).items() if k not in EXCLUSIONS}
    assert not gaps, gaps


JAX_PACKAGES = sorted(m.name[len("sharp_tpu."):] for m in pkgutil.iter_modules(sharp_tpu.__path__, "sharp_tpu.")
                      if m.ispkg)


def _export_differences(package: str):
    """{"package.name": what is wrong} for each name of the JAX subpackage's
    `__all__` that the port's subpackage lacks, exports as another kind of
    object, or takes from elsewhere than the port's module of the JAX
    object's module."""
    jp = importlib.import_module("sharp_tpu." + package)
    tp = importlib.import_module("sharp_tpu_torch." + package)
    out = {}
    for name in jp.__all__:
        theirs, ours = _unjit(getattr(jp, name)), getattr(tp, name, None)
        what = f"{package}.{name}"
        if ours is None:
            out[what] = "missing"
        elif _kind(ours) != _kind(theirs):
            out[what] = f"a {_kind(ours)} in the port, a {_kind(theirs)} in the JAX package"
        else:
            home = "sharp_tpu_torch" + theirs.__module__[len("sharp_tpu"):]
            if getattr(importlib.import_module(home), name, None) is not ours:
                out[what] = f"not the object of {home}"
    return out


@pytest.mark.parametrize("package", JAX_PACKAGES)
def test_subpackage_exports_match_the_jax_package(package):
    gaps = {k: v for k, v in _export_differences(package).items() if k not in EXCLUSIONS}
    assert not gaps, gaps


_CONSTANT = re.compile(r"[A-Z][A-Z0-9_]*")


def _constants(mod):
    """{name: value} of the UPPER_CASE names the module's source assigns at
    its top level (imported names are the other module's)."""
    names = set()
    for node in ast.parse(inspect.getsource(mod)).body:
        targets = node.targets if isinstance(node, ast.Assign) else [node.target] if isinstance(
            node, ast.AnnAssign) else []
        names |= {t.id for t in targets if isinstance(t, ast.Name) and _CONSTANT.fullmatch(t.id)}
    return {n: getattr(mod, n) for n in names if not inspect.ismodule(getattr(mod, n))}


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_constants_match_the_jax_package(module):
    if module in EXCLUSIONS:
        return
    theirs = _constants(importlib.import_module("sharp_tpu." + module))
    ours = importlib.import_module("sharp_tpu_torch." + module)
    gaps = {n: (v, getattr(ours, n, "missing")) for n, v in theirs.items()
            if not (hasattr(ours, n) and getattr(ours, n) == v)}
    assert not gaps, gaps


def test_every_exclusion_names_a_difference():
    """Each row of the table excuses a difference that exists, and has a
    reason."""
    found = {}
    for module in JAX_MODULES:
        found.update(_differences(module))
    for package in JAX_PACKAGES:
        found.update(_export_differences(package))
    found.update({f"cli {f}": "" for f in _cli_differences()})
    found.update({f"env {v}": "" for v in _env_vars("sharp_tpu") ^ _env_vars("sharp_tpu_torch")})
    for key, (_, reason) in EXCLUSIONS.items():
        assert reason.strip(), key
        assert key in found, f"{key} is excused but does not differ"


def test_sharp_config_matches_the_jax_package():
    from sharp_tpu.config import SharpConfig as J
    from sharp_tpu_torch.config import SharpConfig as T

    def fields(cls):
        return [
            (f.name, f.default if f.default_factory is dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)
        ]

    assert fields(T) == fields(J)


class _Parsed(Exception):
    pass


def _cli_arguments(package: str):
    """{subcommand: (positional names, option strings)} of a package's CLI,
    read from the parser that its main() builds."""
    cli = importlib.import_module(package + ".cli")
    seen = {}

    def capture(self, *a, **k):
        seen["parser"] = self
        raise _Parsed

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(_Parsed):
            cli.main(["cluster"])
    finally:
        argparse.ArgumentParser.parse_args = real
    sub = next(a for a in seen["parser"]._actions if isinstance(a, argparse._SubParsersAction))
    out = {}
    for cmd, parser in sub.choices.items():
        pos = [a.dest for a in parser._actions if not a.option_strings]
        opts = {o for a in parser._actions for o in a.option_strings if o not in ("-h", "--help")}
        out[cmd] = (pos, opts)
    return out


def _cli_differences():
    """Flags one CLI has and the other lacks, over all subcommands."""
    theirs, ours = _cli_arguments("sharp_tpu"), _cli_arguments("sharp_tpu_torch")
    assert theirs.keys() == ours.keys()
    diff = set()
    for cmd in theirs:
        assert ours[cmd][0] == theirs[cmd][0], cmd
        diff |= ours[cmd][1] ^ theirs[cmd][1]
    return diff


def test_cli_arguments_match_the_jax_package():
    gaps = {f for f in _cli_differences() if f"cli {f}" not in EXCLUSIONS}
    assert not gaps, gaps


def _env_vars(package: str):
    """The SHARP_TPU_* names a package reads through os.environ.get(...) or
    os.environ[...]."""
    names = set()
    for root, _, files in os.walk(os.path.join(REPO, package)):
        for f in files:
            if not f.endswith(".py"):
                continue
            for node in ast.walk(ast.parse(open(os.path.join(root, f)).read())):
                arg = None
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "get" and isinstance(node.func.value, ast.Attribute)
                        and node.func.value.attr == "environ" and node.args):
                    arg = node.args[0]
                elif (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute)
                      and node.value.attr == "environ"):
                    arg = node.slice
                if isinstance(arg, ast.Constant) and str(arg.value).startswith("SHARP_TPU_"):
                    names.add(arg.value)
    return names


def test_environment_variables_match_the_jax_package():
    theirs, ours = _env_vars("sharp_tpu"), _env_vars("sharp_tpu_torch")
    assert {"SHARP_TPU_HBM_BUDGET", "SHARP_TPU_FOLD_TIMING", "SHARP_TPU_NATIVE_CACHE"} <= theirs
    gaps = {v for v in theirs ^ ours if f"env {v}" not in EXCLUSIONS}
    assert not gaps, gaps
