"""Training of the port: schedules, the flat Adam update and the train step."""
