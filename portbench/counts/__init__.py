"""Work, bytes and peaks: the yardstick of the roofline and mfu metrics."""
