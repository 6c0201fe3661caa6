"""PyTorch/CUDA port of graph_neural_networks_tpu.

Graph shift operators, the LSIGF graph filter, SelectionGNN/LocalGNN, the
attention family (GAT, GCAT, EdgeVariantAttention) and their serving
engine, with hand-written Hopper kernels for the block-sparse graph shift
(``ops/spmm.py``, ``kernels/csrc/spmm.cu``) and for flash banded attention
(``ops/attention_flash.py``, ``kernels/csrc/attention_flash.cu``),
node-sharded execution over a device mesh (``parallel/``), and the
flocking controller (``LocalGNN_DB``) deployed and trained on the
cell-grid swarm environment (``data/flocking.py``, ``ops/gridwin.py``,
``kernels/csrc/gridwin.cu``) and, at the reference scale, on the
all-pairs one. Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
