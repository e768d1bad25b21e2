"""The port's roofline against the H100: its constants, the analytic
bounds, and the cost counter (``count.count_costs``) the dry-run reads."""
