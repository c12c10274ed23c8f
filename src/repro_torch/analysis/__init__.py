"""Cost analysis of the port: per-device operation counts of a step on a
fake process group (`op_cost`) and H100 roofline bounds (`roofline`)."""
