import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py

exec(open("mustache_tpu/_version.py").read())


class BuildWithNative(build_py):
    """Build the native ingest library (io/native) at install time.

    Failure is non-fatal: the pure-Python decoders are a complete
    fallback, so environments without a toolchain still install.
    """

    def run(self):
        try:
            subprocess.run(["make", "-C", "mustache_tpu/io/native"],
                           check=True, timeout=300)
        except Exception as e:  # pragma: no cover - toolchain-dependent
            print(f"warning: native ingest library not built ({e}); "
                  "pure-Python decoders will be used")
        super().run()

setup(
    name="mustache-tpu",
    version=__version__,  # noqa: F821
    description=(
        "TPU-native multi-scale chromatin loop detection for Hi-C and "
        "Micro-C contact maps (scale-space DoG method, JAX/XLA/Pallas)"
    ),
    packages=find_packages(exclude=["tests"]),
    cmdclass={"build_py": BuildWithNative},
    package_data={"mustache_tpu.io.native": ["*.so", "*.cpp", "Makefile"],
                  "mustache_tpu_torch.kernels": ["csrc/*.cu"],
                  "mustache_tpu_torch.io.native": ["*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "pandas", "h5py"],
    # the PyTorch/CUDA port (mustache_tpu_torch); its kernels build with
    # nvcc at first use
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "mustache-tpu = mustache_tpu.cli:main",
            "diff-mustache-tpu = mustache_tpu.diff_cli:main",
            "mustache-tpu-torch = mustache_tpu_torch.cli:main",
        ]
    },
)
