"""Image metrics and host-side statistics of the classic-SR comparison."""
