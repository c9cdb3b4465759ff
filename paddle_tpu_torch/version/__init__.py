"""``paddle_tpu_torch.version`` — version information, counterpart of
``paddle_tpu/version``. ``cuda()`` and ``cudnn()`` report the CUDA and
cuDNN versions torch was built with (``"False"`` without them, the
reference's value when it has none)."""

import torch

full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
cuda_version = str(torch.version.cuda) if torch.version.cuda else "False"
cudnn_version = (str(torch.backends.cudnn.version())
                 if torch.backends.cudnn.is_available() else "False")
xpu_version = "False"
istaged = False
commit = "unknown"
with_pip = True


def show():
    print(f"full_version: {full_version}")
    print(f"major: {major}")
    print(f"minor: {minor}")
    print(f"patch: {patch}")
    print(f"rc: {rc}")
    print(f"commit: {commit}")
    print(f"cuda: {cuda_version}")
    print(f"cudnn: {cudnn_version}")


def cuda():
    return cuda_version


def cudnn():
    return cudnn_version


def xpu():
    return xpu_version
