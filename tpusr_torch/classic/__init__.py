"""The classic-SR comparison: eight classic algorithms and their harness."""
