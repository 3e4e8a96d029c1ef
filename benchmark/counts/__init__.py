"""The operations and bytes that each kernel family's calls need, counted
from the model's published sizes and a call's ray count alone: the work of
the algorithm, once, whatever route a kernel takes. One file per kernel
family of the program (``r2l_fused``: K1, K2; ``r2l_train``: K3, K5;
``nerf_render``: K6). Each family gives ``k*_launches(config,
traffic)``: the (operations, bytes) of each launch that one unit of a
traffic makes, which a traffic's ``kernels`` entry names."""
