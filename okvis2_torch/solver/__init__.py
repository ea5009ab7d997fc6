from okvis2_torch.solver.gauss_newton import problem_cost, solve_window
from okvis2_torch.solver.window_problem import SolverConfig, WindowProblem

__all__ = ["WindowProblem", "SolverConfig", "solve_window", "problem_cost"]
