"""JAX reference results computed once per test session.

Under pytest-xdist (`-n 6 --dist load`) a module's items go to several
workers, and each worker would compute the module's fixtures again: an
expensive JAX Encoder run (its compiles included) as many times as
workers ran the module's items.  `once` computes it on the first worker
that asks, behind a file lock, into the session's shared temporary
directory, and every other worker loads it from there.
"""
import os
import pickle

from filelock import FileLock


def once(tmp_path_factory, name: str, fn):
    """fn(directory) -> a picklable result, computed once per session.
    `directory` holds the files the result names (checkpoints) and is
    shared by the workers.  Without xdist, fn runs in a fresh directory."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return fn(tmp_path_factory.mktemp(name))
    root = tmp_path_factory.getbasetemp().parent / f"jax-{name}"
    done = root / "result.pkl"
    with FileLock(f"{root}.lock"):
        if done.is_file():
            with open(done, "rb") as f:
                return pickle.load(f)
        root.mkdir(exist_ok=True)
        res = fn(root)
        with open(f"{done}.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(f"{done}.tmp", done)
        return res
