from pointcloudattack_tpu_torch.cli.main import main

main()
