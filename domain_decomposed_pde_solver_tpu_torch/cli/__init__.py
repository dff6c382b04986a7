"""Command-line drivers mirroring the reference executables.

| Reference executable       | Driver module                              |
|----------------------------|--------------------------------------------|
| ``BelosMueLuSolver``       | ``...cli.solve``                           |
| ``ExodusIODecomposeTest``  | ``...cli.decompose``                       |
| ``ExodusAssembleTest``     | ``...cli.assemble_test``                   |
| ``ExodusMatrixTest``       | ``...cli.matrix_test``                     |
| ``mpi_output_combiner.py`` | ``...cli.combine``                         |

``solve`` and ``matrix_test`` run on the card unless given ``--cpu``; the
other three are host-only (``python -m
domain_decomposed_pde_solver_tpu_torch.cli.<name>``).
"""
