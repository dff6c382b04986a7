"""The benchmark's plain reference: its mesh generator and the heat
problem's residual in NumPy and SciPy, independent of the program."""
