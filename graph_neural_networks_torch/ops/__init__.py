"""Graph shift operators, SpMM kernels and filter functionals."""
