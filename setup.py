"""Package setup for hemx (the reference shipped a packaged release tarball,
releases/autoencoders-1.0.tar.gz; `python setup.py sdist` is the hemx
equivalent). Also builds the optional C++ data-loader extension."""

from __future__ import annotations

import os

from setuptools import Extension, find_packages, setup

ext_modules = []
if os.environ.get("HEMX_BUILD_NATIVE", "1") == "1":
    ext_modules.append(
        Extension(
            "hemx.data._native",
            sources=["hemx/native/tfrecord.cc"],
            extra_compile_args=["-O3", "-std=c++17"],
            optional=True,  # pure-python fallbacks exist everywhere
        ))

setup(
    name="hemx",
    version="0.1.0",
    description="Autoencoder/GAN research framework "
                "(JAX/XLA rebuild of hem)",
    packages=find_packages(include=["hemx", "hemx.*"]),
    # hemx.native.load() prefers the prebuilt hemx.data._native extension
    # (above); the source is shipped too so the build-on-demand path can
    # still work where the wheel's extension is absent.
    package_data={"hemx.native": ["tfrecord.cc"]},
    py_modules=["train", "paper_train", "experimental", "visualize",
                "paper_metrics", "paper_fullimage", "paper_visualize",
                "events", "visualize_gui", "bench"],
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy"],
    extras_require={"viz": ["matplotlib", "pillow"]},
    ext_modules=ext_modules,
)
