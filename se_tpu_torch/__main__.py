from se_tpu_torch.cli import main

main()
