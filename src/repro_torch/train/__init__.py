"""Training and serving of the LM: AdamW (:mod:`.optimizer`), the train
step (:mod:`.train_loop`), checkpoints (:mod:`.checkpoint`) and greedy
generation (:mod:`.serve`)."""
