"""Run the JAX package's own test cases against the port.

``port_view("test_doctor")`` loads ``tests/test_doctor.py`` a second
time, as a module of its own, with its imports of the modules the port
has (:data:`PORTED`: the telemetry and diagnosis planes, the live server,
the fleet collector, the watchdog, the failure plane and the CLI) pointed
at ``sparkucx_tpu_torch``, string literals included (a case's subprocess
source boots the port's server); everything else it imports (the JAX
node, service and manager) stays the JAX package's. A case of that module
then runs unchanged against the port: the same documents, calls and
assertions.

``run_case(module, name, request, fixtures)`` runs one case function of
either module, taking its fixtures from pytest (``fixtures`` renames the
ones the two sides get differently, e.g. a manager factory) and
expanding its ``parametrize`` marks into ``params``.
"""

import inspect
import os
import re
import types

HERE = os.path.dirname(os.path.abspath(__file__))

# the JAX package's modules the port carries under the same names
PORTED = ("utils.doctor", "utils.anatomy", "utils.slo", "utils.metrics",
          "utils.export", "utils.history", "utils.trace", "utils.live",
          "utils.collector", "shuffle.decisions", "runtime.watchdog",
          "runtime.failures", "__main__")

_MODULE_RE = re.compile(
    r"\bsparkucx_tpu\.(" + "|".join(re.escape(m) for m in PORTED)
    + r")\b")
_FROM_UTILS_RE = re.compile(
    r"\bfrom sparkucx_tpu\.utils import (doctor|anatomy|slo|metrics|"
    r"export|history|trace|live|collector)\b")
_CONF_RE = re.compile(
    r"\bfrom sparkucx_tpu\.config import TpuShuffleConf\b")

_views = {}


def port_view(name: str) -> types.ModuleType:
    """``tests/<name>.py`` with its ported imports pointed at the port
    (one module object per name)."""
    if name not in _views:
        path = os.path.join(HERE, name + ".py")
        with open(path) as f:
            src = f.read()
        src = _MODULE_RE.sub(r"sparkucx_tpu_torch.\1", src)
        src = _FROM_UTILS_RE.sub(r"from sparkucx_tpu_torch.utils import \1",
                                 src)
        src = _CONF_RE.sub("from sparkucx_tpu_torch.config import "
                           "ShuffleConf as TpuShuffleConf", src)
        mod = types.ModuleType(name + "_port")
        mod.__file__ = path
        exec(compile(src, path, "exec"), mod.__dict__)
        _views[name] = mod
    return _views[name]


def params_of(fn) -> list:
    """The argument dicts of ``fn``'s ``parametrize`` marks (one empty
    dict when it has none)."""
    combos = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        rows = [v if len(names) > 1 else (v,) for v in values]
        combos = [{**c, **dict(zip(names, row))}
                  for c in combos for row in rows]
    return combos


def case_ids(module, names) -> list:
    """``(name, params)`` pairs for the cases ``names`` of ``module``,
    one per parametrize combination."""
    out = []
    for name in names:
        for p in params_of(getattr(module, name)):
            out.append((name, p))
    return out


def run_case(module, name: str, params: dict, request,
             fixtures=None) -> None:
    """Call case ``name`` of ``module`` with ``params`` and the pytest
    fixtures its signature names (renamed through ``fixtures``)."""
    fn = getattr(module, name)
    fixtures = fixtures or {}
    kwargs = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = request.getfixturevalue(fixtures.get(arg, arg))
    fn(**kwargs)
