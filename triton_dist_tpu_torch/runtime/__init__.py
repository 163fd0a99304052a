from triton_dist_tpu_torch.runtime.platform import (  # noqa: F401
    device_report,
    nvidia_smi_line,
    resolve_device,
)
