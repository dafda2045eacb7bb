"""Schedules, the train step of the flagship recipe, and the experiment dir."""
