"""Small helpers shared by the operators."""
