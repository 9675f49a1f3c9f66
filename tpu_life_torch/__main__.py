from tpu_life_torch.cli import console_main

if __name__ == "__main__":
    raise SystemExit(console_main())
