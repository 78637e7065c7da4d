"""Bias-tweak inference — named-binary parity with the reference's
`inference_bias.py`.

Rebuild of `/root/reference/code_student_uniform/inference_bias.py`: run
inference with one bias parameter rescaled as
`new = old/alpha + mean(old - old/alpha)` (:158-161). This is a thin
front-end over cli/infer.py, which implements the rescaling
(`rescale_bias_param`).
"""

from __future__ import annotations

import sys

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.cli.infer import inference
from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
    enable_compilation_cache,
)


def main(argv=None):
    flags_lib.setup_logging()
    enable_compilation_cache()
    parser = flags_lib.base_parser("Inference with a rescaled bias tensor")
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--tensor_name", required=True,
                        help="params path of the bias, e.g. "
                        "classifier/experts/b")
    parser.add_argument("--alpha_bias", type=float, default=2.0)
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args)
    inference(args)


if __name__ == "__main__":
    main(sys.argv[1:])
