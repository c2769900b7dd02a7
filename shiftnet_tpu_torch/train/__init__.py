"""Training of the port: schedules, optimizer and losses, step, trainer."""
