"""The plain reference that decides `correct`: plain PyTorch that runs on any
device and imports nothing of the program under test (`tpu_bvh_torch`), nor
`jax` or `tpu_bvh`.

* `build`: the front half (leaf boxes, scene extents, extended Morton codes,
  the (code, primitive) order), the single-pass LBVH as the binary radix tree
  of the 64-bit keys (code, position), and PLOC++ round by round;
* `traverse`: closest hits of rays through a tree, near child first;
* `compare`: the numbers compared, each with its limit.

Every function takes a `dtype` for its floating-point arithmetic: float32 is
the configuration's precision, and bfloat16 gives the control.
"""
