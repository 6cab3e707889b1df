"""Example problems (the flagship chain estimation)."""
