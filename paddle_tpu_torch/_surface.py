"""The Paddle-shaped top-level namespace of ``paddle_tpu_torch``, in the
order of ``paddle_tpu/__init__.py`` (the hand-written ops first, then the
schema-generated ones for the names still missing, then creation and the
random stream). The package loads it on the first attribute it does not
hold itself (``paddle_tpu_torch.__getattr__``), so ``import
paddle_tpu_torch`` alone imports nothing of torch."""

from . import flags  # noqa: F401  (registers the flag corpus first)
from .flags import get_flags, set_flags  # noqa: F401

from .core.tensor import Tensor, Parameter  # noqa: F401
from .core.place import (  # noqa: F401
    CPUPlace, TPUPlace, XLAPlace, CUDAPlace, set_device, get_device,
    is_compiled_with_tpu,
)
from .core.autograd import (  # noqa: F401
    no_grad, enable_grad, set_grad_enabled, is_grad_enabled, grad,
)
from .core.dtype import (  # noqa: F401
    bool_ as bool, uint8, int8, int16, int32, int64, float16, bfloat16,
    float32, float64, complex64, complex128,
    set_default_dtype, get_default_dtype,
)
from .core.math_ops import *  # noqa: F401,F403
from .core.math_ops import sum, max, min, abs, all, any, pow, round  # noqa: F401
from .core.extra_ops import (  # noqa: F401
    is_complex, is_floating_point, is_empty, rank, tolist, broadcast_shape,
    clone, view, broadcast_tensors, unstack, hsplit, vsplit, dsplit, slice,
    shard_index, unique_consecutive, inverse, poisson, hstack,
    vstack, row_stack, column_stack, dstack, atleast_1d, atleast_2d,
    atleast_3d, tensor_split, mode, masked_scatter, diagonal_scatter,
    select_scatter, slice_scatter, histogramdd,
    frac, gammaln, isin, clip_, geometric_, index_put, index_put_, unfold,
)
from .core import op_schema as _op_schema  # noqa: E402
_op_schema.install(globals())  # schema-generated ops (only missing names)
from .creation import (  # noqa: F401,E402
    to_tensor, zeros, ones, full, empty, zeros_like, ones_like, full_like,
    empty_like, arange, linspace, logspace, eye, meshgrid, diag_embed,
    rand, randn, randint, randperm, uniform, normal, multinomial, bernoulli,
    create_parameter,
)
from .random import seed, get_rng_state, set_rng_state  # noqa: F401,E402
from .framework import save, load  # noqa: F401,E402

from . import nn  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import ops  # noqa: F401,E402
from . import amp  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import framework  # noqa: F401,E402
from . import io  # noqa: F401,E402
