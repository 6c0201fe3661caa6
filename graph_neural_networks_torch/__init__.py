"""PyTorch/CUDA port of graph_neural_networks_tpu.

Graph shift operators, the LSIGF graph filter, SelectionGNN/LocalGNN and
their serving engine, with hand-written Hopper kernels for the block-sparse
graph shift (``ops/spmm.py``, ``kernels/csrc/spmm.cu``). Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""
