"""Application layer: runnable offline pipelines (port of loc_lib_tpu/apps).

CLI replay drivers over the npz log format (io/logdir.py), in place of the
reference's ROS mapping and matching nodes:

    python -m loc_lib_tpu_torch.apps.mapping   --log <dir> --out <dir> [--config y.yaml]
    python -m loc_lib_tpu_torch.apps.matching  --log <dir> --map <map> --out <dir>
    python -m loc_lib_tpu_torch.apps.slam      --log <dir> --out <dir>
    python -m loc_lib_tpu_torch.apps.mapping2d --log <dir> --out <dir>

Each accepts `--demo` to synthesize its input log. They run on the card
(and fail with a clear error where there is none); the `run_*` functions
take `device="cpu"` for the CPU.
"""
