"""Command-line drivers (``python -m domain_decomposed_pde_solver_tpu_torch.cli.solve``)."""
