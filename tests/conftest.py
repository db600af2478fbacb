import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _install_hypothesis_shim():
    """Register a minimal ``hypothesis`` stand-in so test modules collect
    (and run, with plain-random examples) on machines without the real
    package. The shim covers only the API surface this repo uses:
    given/settings and the strategies builds, lists, sampled_from,
    integers, just, tuples, booleans, floats, plus Strategy.map.
    """
    import functools
    import random
    import types

    class Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example(self, rng):
            return self._draw(rng)

        def map(self, f):
            return Strategy(lambda rng: f(self._draw(rng)))

    def sampled_from(seq):
        items = list(seq)
        return Strategy(lambda rng: items[rng.randrange(len(items))])

    def integers(min_value=0, max_value=2**31 - 1):
        return Strategy(lambda rng: rng.randint(min_value, max_value))

    def just(value):
        return Strategy(lambda rng: value)

    def booleans():
        return Strategy(lambda rng: rng.random() < 0.5)

    def floats(min_value=0.0, max_value=1.0, allow_nan=True,
               allow_infinity=None, width=None):
        return Strategy(lambda rng: rng.uniform(min_value, max_value))

    def lists(elements, min_size=0, max_size=None):
        hi = max_size if max_size is not None else min_size + 10
        return Strategy(
            lambda rng: [elements.example(rng)
                         for _ in range(rng.randint(min_size, hi))])

    def tuples(*strategies):
        return Strategy(lambda rng: tuple(s.example(rng) for s in strategies))

    def builds(target, *arg_strategies, **kwarg_strategies):
        return Strategy(lambda rng: target(
            *(s.example(rng) for s in arg_strategies),
            **{k: s.example(rng) for k, s in kwarg_strategies.items()}))

    def given(*strategies):
        def deco(fn):
            max_attr = "_shim_max_examples"

            @functools.wraps(fn)
            def wrapper():
                n = getattr(wrapper, max_attr, None) or getattr(
                    fn, max_attr, None) or 20
                for i in range(n):
                    rng = random.Random(0xC0FFEE + i)
                    fn(*(s.example(rng) for s in strategies))

            # pytest follows __wrapped__ for its signature and would treat
            # the strategy parameters as fixtures; hide the original.
            del wrapper.__wrapped__
            return wrapper

        return deco

    def settings(max_examples=20, deadline=None, **_ignored):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn

        return deco

    mod = types.ModuleType("hypothesis")
    st_mod = types.ModuleType("hypothesis.strategies")
    for name, obj in (("sampled_from", sampled_from), ("integers", integers),
                      ("just", just), ("booleans", booleans),
                      ("floats", floats), ("lists", lists),
                      ("tuples", tuples), ("builds", builds)):
        setattr(st_mod, name, obj)
    mod.given = given
    mod.settings = settings
    mod.strategies = st_mod
    mod.__is_shim__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


try:
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test body "
        "on a host without one")


def run_in_subprocess(code: str, devices: int = 8, timeout: int = 600) -> str:
    """Run a python snippet with N forced host devices (the parent process
    keeps its single device, per the dry-run isolation rule)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + ":" + REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=timeout, cwd=REPO)
    if out.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:{out.stdout[-3000:]}\n"
            f"STDERR:{out.stderr[-3000:]}")
    return out.stdout


@pytest.fixture
def subproc():
    return run_in_subprocess
