from setuptools import find_packages, setup

setup(
    name="sharkmer-tpu",
    version="0.1.0",
    description="k-mer counting and in silico PCR on an accelerator",
    packages=find_packages(exclude=("tests",)),
    package_data={"sharkmer_tpu": ["panels/*.yaml", "panels/README.md"]},
    entry_points={"console_scripts": ["sharkmer=sharkmer_tpu.main:main",
        "sharkmer-viewer=sharkmer_tpu.viewer:main"]},
    python_requires=">=3.10",
)
