"""CLI entry point: ``python -m tpu3d [config.yaml]``.

Mirrors the reference binary's interface (src/main.cpp:80-94): one optional
positional argument, the config path, defaulting to
``config/pipeline_config.yaml``.
"""

import sys

from tpu3d.config import load_config
from tpu3d.pipeline.pipeline import Pipeline
from tpu3d.utils.platform import enable_compile_cache


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    enable_compile_cache()
    print("=== tpu3d — bin-picking pipeline ===\n")
    config_path = argv[0] if argv else "config/pipeline_config.yaml"
    config = load_config(config_path)
    pipeline = Pipeline(config)
    pipeline.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
