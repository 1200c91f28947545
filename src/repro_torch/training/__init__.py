"""Step builders of the port's LM stack (``steps``): the serving steps.
Training (the train step, loss, optimizer, data, checkpoints) is a later
slice, ROADMAP Queue 1 item 5g."""
