"""Runnable examples of the port (counterpart of baselines_tpu/examples): deepq on
CartPole saved and replayed, and ppo2 with a network registered by the user. Each keeps
its ``learn`` keywords in a module-level dict, and ``main()`` runs them on the card:

    python -m baselines_tpu_torch.examples.train_cartpole
    python -m baselines_tpu_torch.examples.enjoy_cartpole
    python -m baselines_tpu_torch.examples.custom_network
"""
