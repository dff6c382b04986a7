"""The run's environment, set before the program is imported: fixed build
and kernel-cache directories inside the checkout, so that only a
checkout's first run builds."""

import os
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]


def prepare(root: pathlib.Path = ROOT) -> None:
    build = pathlib.Path(root) / "build"
    os.environ.pop("DDPS_NO_COMPILE_CACHE", None)
    os.environ["DDPS_COMPILE_CACHE"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
